"""K7's tensor-core design on the CPU: its design table and chunk plan, and
a plain-torch emulation of its order of work against the JAX package on
the same numpy inputs.

The emulation does what ``csrc/ssd_hopper.cu`` does, in float32: per chunk
of Q tokens the running sum of a left to right; pass 1, each chunk's
state (w xdt)^T . B with w xdt split into bf16 parts; pass 2, the
recurrence over the chunks from ``init_state``; pass 3, exp(cum) C . H
with the state split into parts, plus the masked, decayed score tile
times xdt over 16 x 16 tiles with the decayed scores split into parts.
Products of bf16-valued operands are exact in float32, so only the split
and the order of the sums part it from the references.

References: ``repro.kernels.ops.ssd_chunk_scan(backend="interpret")``
(the Pallas kernel in interpret mode) on whole chunks without a state,
and ``repro.models.ssm.ssd_scan`` and ``repro.kernels.ref.
ref_ssd_chunk_scan`` from an ``init_state`` with a ragged tail.

Tolerance: with three parts (fp32's 24 bits of mantissa) y and the final
state within rtol 1e-5 and atol 1e-5 x the largest |reference|, as the
JAX package's float32 scans hold each other (the same sums in another
order). Two parts carry 16 bits: the same inputs then read at least four
times the three-part error, so the third part is what keeps the design
at fp32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.ops import ssd_chunk_scan as j_ssd_chunk_scan
from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as ss

RTOL = 1e-5
ATOL = 1e-5
#: bf16 parts of a float32 operand in the kernel (``kParts`` of
#: ``csrc/ssd_hopper.cu``)
PARTS = 3
#: the SMs of an H100, whose count the wrapper reads from the card
H100_SMS = 132


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 values (kept as float32)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(b, s, h, n, seed):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.normal(size=(b, s, h, 64)).astype(np.float32) * 0.1),
            -np.abs(rng.normal(size=(b, s, h))).astype(np.float32) * 0.1,
            _bf16(rng.normal(size=(b, s, n)).astype(np.float32)),
            _bf16(rng.normal(size=(b, s, n)).astype(np.float32)),
            rng.normal(size=(b, h, 64, n)).astype(np.float32))


def _parts(x: torch.Tensor, parts: int) -> list:
    """x as ``parts`` bf16-valued tensors: bf16(x), then the rest."""
    out, rest = [], x
    for _ in range(parts):
        hi = rest.to(torch.bfloat16).float()
        out.append(hi)
        rest = rest - hi
    return out


def emulate(xdt, a, B, C, init_state, q: int, parts: int):
    """The tensor design's order of work in plain torch (float32, CPU):
    (y float32, final state)."""
    xdt, a, B, C = (torch.from_numpy(np.asarray(t)) for t in (xdt, a, B, C))
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    nc = -(-s // q)
    pad = nc * q - s

    def chunks(t):
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, q, *t.shape[2:])

    x, av, Bc, Cc = chunks(xdt), chunks(a), chunks(B), chunks(C)
    cum = torch.cumsum(av, dim=2)              # left to right, per head
    total = cum[:, :, -1]                      # [b, nc, h]
    # pass 1: S_c = (w xdt)^T . B, w xdt split into parts
    w = torch.exp(torch.clamp(total[:, :, None] - cum, max=0.0))
    xw = x * w[..., None]
    S = sum(torch.einsum("bcjhp,bcjn->bchpn", part, Bc)
            for part in _parts(xw, parts))
    # pass 2: the state entering each chunk, and the final one
    state = torch.zeros((b, h, p, n)) if init_state is None \
        else torch.from_numpy(np.asarray(init_state))
    enter = []
    for c in range(nc):
        enter.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state + S[:, c]
    H = torch.stack(enter, dim=1)              # [b, nc, h, p, n]
    # pass 3: exp(cum) C . H^T, then the intra-chunk tiles
    y = sum(torch.einsum("bcin,bchpn->bcihp", Cc, part)
            for part in _parts(H, parts)) * torch.exp(cum)[..., None]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool))
    ldecay = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.where(mask[None, None, :, :, None],
                    torch.exp(torch.clamp(ldecay, max=0.0)), 0.0)
    M = scores[..., None] * L                  # [b, nc, i, j, h]
    for jt in range(q // 16):                  # the kernel's column tiles
        cols = slice(16 * jt, 16 * jt + 16)
        y = y + sum(torch.einsum("bcijh,bcjhp->bcihp", part, x[:, :, cols])
                    for part in _parts(M[:, :, :, cols], parts))
    return y.reshape(b, nc * q, h, p)[:, :s], state


def _err(got, want) -> float:
    """The largest |got - want| over the largest |want|."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _close(got, want):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=RTOL,
                               atol=ATOL * float(np.abs(w).max()))


# ------------------------------------------------------- the design table
def test_design_table():
    bf, f32 = torch.bfloat16, torch.float32
    assert ss.ssd_design(bf, 64, 128) == "tensor"      # mamba2-780m
    assert ss.ssd_design(bf, 64, 16) == "tensor"       # hymba-1.5b
    for dtype, p, n in ((f32, 64, 128), (f32, 64, 16), (bf, 32, 128),
                        (bf, 64, 64), (bf, 64, 256)):
        assert ss.ssd_design(dtype, p, n) == "cuda_core"
    assert ss.ssd_design(bf, 64, 128, "cuda_core") == "cuda_core"
    with pytest.raises(ValueError, match="tensor design takes"):
        ss.ssd_design(f32, 64, 128, "tensor")
    with pytest.raises(ValueError, match="none of"):
        ss.ssd_design(bf, 64, 128, "wgmma")
    assert ss.kernel_chunk(bf, 64, 128) == 128      # measured, PERF.md
    assert ss.kernel_chunk(bf, 64, 16) == 64
    assert ss.kernel_chunk(f32, 64, 128) == ss.KERNEL_CHUNK["cuda_core"] \
        == 64
    assert ss.kernel_chunk(bf, 64, 128, "cuda_core") == 64
    assert set(ss.KERNEL_CHUNK["tensor"]) == set(ss.TENSOR_N)
    assert set(ss.KERNEL_CHUNK["tensor"].values()) <= set(ss.TENSOR_CHUNKS)


@pytest.mark.parametrize("shape,q,want", [
    # b, s, h, n: 9a's launch, 9c's, hymba's
    ((4, 32768, 48, 128), 128, (256, 8)),
    ((1, 4096, 48, 128), 128, (32, 5)),
    ((4, 4096, 50, 16), 64, (64, 8)),
    ((4, 32768, 48, 128), 64, (512, 8)),
    ((1, 37, 5, 16), 128, (1, 1)),
], ids=["9a", "9c", "hymba", "9a-q64", "short"])
def test_chunk_plan(shape, q, want):
    """Chunks and a pass-3 block's heads (up to 8, fewer where the grid
    would not fill the 132 SMs twice), and the workspace: a [64, n] fp32
    state and a total per chunk, head and batch row (1.6 GB at 9a's launch
    and Q 128, twice that at Q 64)."""
    b, s, h, n = shape
    nc, heads, words = ss.tensor_plan(b, s, h, n, q, H100_SMS)
    assert (nc, heads) == want
    assert words == b * nc * h * (64 * n + 1)
    if shape == (4, 32768, 48, 128):
        assert abs(words * 4 - 1.61e9 * 128 / q) < 0.01 * 1.61e9 * 128 / q
    for bad in (32, 256):
        with pytest.raises(ValueError):
            ss.tensor_plan(b, s, h, n, bad, H100_SMS)


# ------------------------------------------------------------ the emulation
@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("q", ss.TENSOR_CHUNKS)
def test_emulation_matches_the_pallas_kernel(n, q):
    """Whole chunks, no state: the Pallas kernel in interpret mode, at the
    emulation's own chunk."""
    xdt, a, B, C, _ = _inputs(2, 512, 4, n, seed=q + n)
    want = j_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), chunk=q,
                            head_block=4, backend="interpret")
    y, _ = emulate(xdt, a, B, C, None, q, PARTS)
    _close(y.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,s", [(16, 600), (128, 600), (128, 37)],
                         ids=["n16-ragged", "n128-ragged", "n128-short"])
def test_emulation_matches_the_model_scan_and_the_oracle(n, s):
    """From an init_state with a ragged tail: the JAX model's chunked scan
    (at the model's chunk of 256) and the sequential oracle, y and the
    final state."""
    xdt, a, B, C, h0 = _inputs(2, s, 4, n, seed=s + n)
    y, st = emulate(xdt, a, B, C, h0, ss.kernel_chunk(torch.bfloat16, 64, n),
                    PARTS)
    yj, sj = JS.ssd_scan(*map(jnp.asarray, (xdt, a, B, C)), 256,
                         init_state=jnp.asarray(h0))
    _close(y.numpy(), np.asarray(yj))
    _close(st.numpy(), np.asarray(sj))
    yr, sr = JR.ref_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), 256,
                                   init_state=jnp.asarray(h0))
    _close(y.numpy(), np.asarray(yr))
    _close(st.numpy(), np.asarray(sr))


def test_two_parts_are_not_enough():
    """The same inputs with two bf16 parts: at least four times the
    three-part error against the sequential oracle, in y and in the
    state."""
    xdt, a, B, C, h0 = _inputs(2, 600, 4, 128, seed=9)
    yr, sr = JR.ref_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), 256,
                                   init_state=jnp.asarray(h0))
    q = ss.kernel_chunk(torch.bfloat16, 64, 128)
    y3, s3 = emulate(xdt, a, B, C, h0, q, 3)
    y2, s2 = emulate(xdt, a, B, C, h0, q, 2)
    assert _err(y2, yr) >= 4 * _err(y3, yr)
    assert _err(s2, sr) >= 4 * _err(s3, sr)


def test_emulation_makes_no_nan_under_large_decays():
    """a about -2.5 a token: cum falls past fp32's 88.7 within a chunk;
    decays are taken only where j <= i and clamped, so nothing overflows
    and y stays finite and close to the oracle's."""
    xdt, a, B, C, _ = _inputs(1, 512, 4, 16, seed=6)
    a = a * 25.0
    assert float(a[0, :64].sum(0).min()) < -88.7
    y, st = emulate(xdt, a, B, C, None,
                    ss.kernel_chunk(torch.bfloat16, 64, 16), PARTS)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    yr, sr = JR.ref_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), 256)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-4,
                               atol=1e-4 * float(np.abs(yr).max()))
