"""The limits that hold the bf16 tensor-core flash kernels (K5 and K6 of
the ``wgmma`` design, ``kernels/flash_tiles.py``) against the float32
oracle, the plain versions on the same bf16 inputs. ``chip_smoke.py`` and
the ``gpu`` tests read them; ``tests/test_torch_flash_rounding.py`` holds
them to the JAX Pallas kernels' own readings.

The wgmma design rounds P (and, backward, dS) to bf16 before its product,
where the Pallas kernels round them, so it no longer computes the
all-fp32 function that the CUDA-core design rounds once: one bf16 ulp of
the oracle cannot hold. Readings of the Pallas kernels in interpret mode
(``flash_attention_pallas``, ``flash_attention_bwd_pallas``) against the
oracle on 1 x 1,024 tokens, 4 heads over 1 or 2 KV heads, D 64 and 128,
causal, causal with a window of 256, and neither (12 cases, numpy seed
0): the worst row's norm-relative error 2.88e-3 to 3.31e-3 for o and
3.09e-3 to 4.58e-3 for dq, dk and dv; the whole tensor's 1.99e-3 to
2.28e-3 and 2.23e-3 to 2.37e-3; elementwise up to 155 ulps in o and 258
in the gradients.
"""
import torch

#: a row is one position of one head (D values); its norm-relative error
#: ||out - ref|| / ||ref|| counts a row norm below ROW_FLOOR x the largest
#: row norm of the tensor as that floor (a gradient row that cancels to
#: near 0 would otherwise divide by nothing)
ROW_FLOOR = 2.0 ** -10
#: the worst row of o: 2.4x to 2.8x the Pallas forward's readings above
FWD_ROW_RTOL = 8e-3
#: the worst row of dq, dk and dv: 2.0x to 2.9x the Pallas backward's
BWD_ROW_RTOL = 9e-3
#: elementwise, in bf16 ulps of the larger magnitude, with the CUDA-core
#: checks' floors (o: 2**-10 absolute; gradients: 2**-10 x the largest
#: |reference|). Rounding P moves an output by up to 2**-9 of its largest
#: P.V term, hundreds of ulps of an output that cancels to near the
#: floor: the Pallas kernels read up to 258 ulps on tensors of at most
#: 524,288 elements, and the replays hold 10 to 38 million, whose tails
#: reach further. A sanity bound (NaN, a lost tile's garbage); the row
#: check is the sharp one.
ULP_LIMIT = 1024.0
#: a planted fault must read at least this many times its limit
CONTROL_FACTOR = 10.0


def row_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's norm-relative error of ``out`` against ``ref``
    (rows along the last dimension, in float32), row norms floored at
    ROW_FLOOR x the largest; NaN elements, which the callers hold to the
    same places on both sides, count as equal."""
    a, b = out.float(), ref.float()
    nan = torch.isnan(a) | torch.isnan(b)
    diff = torch.where(nan, torch.zeros_like(a), a - b)
    norm = torch.where(nan, torch.zeros_like(b), b).norm(dim=-1)
    if norm.numel() == 0:
        return 0.0
    floor = max(float(norm.max()) * ROW_FLOOR, 1e-30)
    return float((diff.norm(dim=-1) / norm.clamp(min=floor)).max())


def ulp_error(out: torch.Tensor, ref: torch.Tensor, floor: float) -> float:
    """The largest elementwise difference in bf16 ulps of the larger
    magnitude, magnitudes below ``floor`` counted as ``floor``; NaN
    elements count as equal."""
    a, b = out.float(), ref.float()
    nan = torch.isnan(a) | torch.isnan(b)
    diff = torch.where(nan, torch.zeros_like(a), (a - b).abs())
    mag = torch.maximum(a.abs(), b.abs()).nan_to_num(0.0).clamp(min=floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float((diff / ulp).max()) if diff.numel() else 0.0
