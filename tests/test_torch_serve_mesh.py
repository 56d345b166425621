"""Serving under a mesh, the pieces that need no process group, on one
process: the log-sum-exp merge of the context-parallel decode's
per-slice partials against the whole ``decode_attention``; the
vocab-parallel argmax (``serve_step.vocab_argmax``) on ranks that are
threads of this process, exchanging through a barrier in place of a
process group; ``Model.cache_specs`` and the cache's global shapes
against the JAX package's for every config, and ``init_cache``'s
per-rank pieces under the serving rules.

The sharded prefill and decode themselves, against JAX's executed
sharded cells, are in ``tests/test_torch_lm_parallel.py``'s world.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models.model import build_model as j_build_model
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import MeshConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models.attention import decode_attention, \
    decode_partials, merge_partials
from repro_torch.models.model import build_model
from repro_torch.serve import serve_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked(fn):
    """A reducer over the slices stacked on a leading dim: every slice
    gets the reduction, as every rank gets an all-reduce's."""
    return lambda t: fn(t, dim=0, keepdim=True).expand_as(t)


def _amax(t, dim, keepdim):
    return t.amax(dim=dim, keepdim=keepdim)


@pytest.mark.parametrize("n_written", [37, 9, 1])
@pytest.mark.parametrize("slices", [2, 4])
def test_merge_of_slice_partials_matches_decode_attention(slices, n_written):
    """Each slice's partials (its max, sum of exponentials and readout),
    merged by the log-sum-exp rule, against ``decode_attention`` over the
    whole cache in float32 (GQA, 8 q heads on 2 KV heads). With 9 or 1
    slots written, the later slices hold no valid slot: they give
    (-1e30, 0, 0) and weigh nothing."""
    g = torch.Generator().manual_seed(0)
    b, s, hs, hq, dh = 3, 48, 2, 8, 16
    q = torch.randn((b, 1, hq, dh), generator=g)
    k = torch.randn((b, s, hs, dh), generator=g)
    v = torch.randn((b, s, hs, dh), generator=g)
    valid = (torch.arange(s) < n_written)[None, :].expand(b, s)
    want = decode_attention(q, k, v, valid)
    step = s // slices
    parts = [decode_partials(q, k[:, i:i + step], v[:, i:i + step],
                             valid[:, i:i + step])
             for i in range(0, s, step)]
    empty = [i for i in range(slices) if i * step >= n_written]
    for i in empty:
        m, l, acc = parts[i]
        assert bool((m == -1e30).all()) and not l.any() and not acc.any()
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    got = merge_partials(m, l, acc, _stacked(_amax), _stacked(torch.sum))
    for r in range(slices):
        np.testing.assert_allclose(got[r].reshape(b, 1, hq, dh).numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-6)


def test_a_slice_alone_is_not_the_whole():
    """The control: one slice's partials normalised alone (the merge's
    reduce dropped) are not the whole cache's attention."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 1, 4, 16), generator=g)
    k, v = (torch.randn((2, 32, 1, 16), generator=g) for _ in range(2))
    valid = torch.ones((2, 32), dtype=torch.bool)
    want = decode_attention(q, k, v, valid)
    got = merge_partials(*decode_partials(q, k[:, :16], v[:, :16],
                                          valid[:, :16]),
                         lambda t: t, lambda t: t)
    assert not np.allclose(got.reshape(want.shape).numpy(), want.numpy(),
                           rtol=1e-3, atol=1e-3)


# ------------------------------------------------ ranks as threads
class _ThreadMesh:
    """``n`` ranks along ``model`` as threads: ``all_reduce`` puts this
    rank's tensor on a board and reduces the board once every rank has
    put its own."""

    def __init__(self, n):
        self.n = n
        self.board = [None] * n
        self.barrier = threading.Barrier(n)
        self.local = threading.local()

    # the Mesh interface the model code reads
    @property
    def world(self):
        return self.n

    def size(self, axis):
        return self.n if axis == "model" else 1

    def index(self, axis):
        return self.local.rank if axis == "model" else 0

    def all_reduce(self, x, mesh, axes, op="sum", kind="all_reduce"):
        self.board[self.local.rank] = x.clone()
        self.barrier.wait()
        stack = torch.stack(self.board)
        out = {"sum": stack.sum(0), "max": stack.amax(0),
               "min": stack.amin(0)}[op]
        self.barrier.wait()
        return out

    def run(self, fn):
        """``fn(rank)`` on every rank, each in its own thread under a
        ``ShardCtx`` of this mesh with ``VOCAB -> model``."""
        out, errors = [None] * self.n, []
        ctx = shd.ShardCtx(self, {shd.VOCAB: "model"})

        def rank_main(r):
            self.local.rank = r
            try:
                with shd.use_ctx(ctx):
                    out[r] = fn(r)
            except BaseException as e:   # raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        if errors:
            raise errors[0]
        return out


def _vocab_argmax_on_ranks(logits, n, monkeypatch):
    mesh = _ThreadMesh(n)
    monkeypatch.setattr(col, "all_reduce", mesh.all_reduce)
    step = logits.shape[-1] // n
    return mesh.run(lambda r: serve_step.vocab_argmax(
        logits[..., r * step:(r + 1) * step]))


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_argmax_breaks_ties_to_the_first_index(n, monkeypatch):
    """Ties within a shard and across shards (rows 0-2), a row whose max
    is on the last shard (3) and a random row (4): every rank gets the
    first index of the global max, as ``jnp.argmax``."""
    v = 64
    logits = torch.randn((5, 1, v), generator=torch.Generator()
                         .manual_seed(2))
    logits[0, 0, [5, 9]] = 7.0                    # a tie inside shard 0
    logits[1, 0, [v // n - 1, v - 1]] = 7.0       # across shards
    logits[2, 0, [v // 2 + 3, v // 2 + 4]] = 7.0  # inside a later shard
    logits[3, 0, v - 2] = 9.0
    want = jax.device_get(jax.numpy.argmax(logits.numpy(), axis=-1))
    assert want[:, 0].tolist()[:4] == [5, v // n - 1, v // 2 + 3, v - 2]
    for got in _vocab_argmax_on_ranks(logits, n, monkeypatch):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_vocab_argmax_never_picks_a_pad_column(monkeypatch):
    """qwen3-moe-30b's 151,936 pads to 152,064 on the last ``model``
    shard: with every real logit below -1e29 (so that only the -1e30
    mask stands between the pads and the max), the argmax is still a
    real column, on every rank."""
    from repro_torch.models.layers import unembed_apply
    cfg = get_config("qwen3-moe-30b-a3b")
    vp = shd.pad_vocab(cfg.vocab_size)
    assert vp - cfg.vocab_size == 128
    x = torch.zeros((1, 1, 8))
    w = torch.zeros((8, vp))
    small = dataclasses.replace(cfg, d_model=8, tie_embeddings=False)
    logits = unembed_apply({"unembed": w}, x, small)
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())
    logits[..., :cfg.vocab_size] = -1e29 * 0.99
    logits[..., 7] = -1e29 * 0.98
    for got in _vocab_argmax_on_ranks(logits, 2, monkeypatch):
        assert got.item() == 7


# --------------------------------------------------------- cache specs
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_and_shapes_match_jax(arch, bits):
    """``cache_specs`` (logical axes, the stacked ``layers`` axis kept)
    and every leaf's global shape and type, against the JAX ``Model``'s
    ``cache_specs`` and ``init_cache``, for every config (reduced)."""
    jm = j_build_model(j_reduced(j_get_config(arch)), kv_cache_bits=bits)
    tm = build_model(reduced(get_config(arch)), kv_cache_bits=bits,
                     device="cpu")
    assert tm.cache_specs() == jm.cache_specs()
    want = jax.eval_shape(lambda: jm.init_cache(3, 24))
    got = tm.cache_shapes(3, 24)
    assert set(got) == set(want["layers"])
    for k, (shape, dtype) in got.items():
        assert shape == want["layers"][k].shape, k
        assert str(dtype).split(".")[-1] == str(want["layers"][k].dtype), k


class _Mesh:
    """The coordinates of one rank of a (data, model) mesh."""

    def __init__(self, shape, coords):
        self.shape, self.coords = dict(zip(("data", "model"), shape)), \
            dict(zip(("data", "model"), coords))

    @property
    def world(self):
        return self.shape["data"] * self.shape["model"]

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)


@pytest.mark.parametrize("kind,batch", [("prefill", 4), ("decode", 4),
                                        ("decode", 1)])
def test_init_cache_allocates_this_ranks_piece(kind, batch):
    """Under the (2, 2) mesh's serving rules, the reduced starcoder2-7b's
    cache on rank (1, 1): prefill keeps its stored KV heads (two, each
    head repeated for ``model``), decode every head over half of the 40
    slots (``KV_SEQ -> model``), the batch over ``data`` unless it does
    not divide; ``pos`` a 0-dim scalar."""
    cfg = reduced(get_config("starcoder2-7b"))
    mesh_cfg = MeshConfig((2, 2), ("data", "model"))
    prof = shd.sharding_profile(cfg, mesh_cfg, batch, 40, kind)
    ctx = shd.ShardCtx(_Mesh((2, 2), (1, 1)),
                       shd.make_rules(cfg, mesh_cfg, batch, 40, kind), prof)
    with shd.use_ctx(ctx):
        model = build_model(cfg, kv_repeat=prof.kv_repeat, kv_cache_bits=8,
                            device="cpu")
        cache = model.init_cache(batch, 40)
    b = batch // 2 if batch % 2 == 0 else batch
    hs, s = (1, 40) if kind == "prefill" else (1, 20)
    assert prof.kv_seq_shard == (kind == "decode")
    assert cache["pos"].shape == ()
    L, dh = cfg.num_layers, cfg.resolved_head_dim
    assert tuple(cache["layers"]["k"].shape) == (L, b, s, hs, dh)
    assert tuple(cache["layers"]["k_scale"].shape) == (L, b, s, hs)
