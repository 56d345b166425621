"""Mamba-2 / SSD block (state-space duality, arXiv:2405.21060), as the JAX
package's ``models/ssm.py`` computes it.

Recurrence (per head h, state dim n, head dim p):
    h_t = exp(dt_t·A) h_{t-1} + B_t (dt_t x_t)
    y_t = C_t · h_t + D x_t
with A a negative scalar per head and B/C shared across heads
(n_groups = 1).

The JAX package runs the chunked SSD as ``jnp`` under ``lax.scan``; here
``ssd_scan`` is K7 (``kernels/ssd_scan.py``) for a CUDA tensor and its
plain version, the same chunked algorithm in plain torch, for a CPU
tensor. Both are differentiable through ``ssd_scan_bwd``, the JAX reverse
scan over checkpointed chunks, so ``ssd_forward`` trains as the JAX block
does under ``jax.value_and_grad``; the serving path calls it under
``torch.no_grad`` and builds no graph. ``ssd_decode`` is the single-token step in plain torch, as the
JAX package has no kernel there either. Parameters keep the JAX layout
and names: ``z``/``x`` [d, nh, p], ``B``/``C`` [d, n], ``dt`` [d, nh],
``o`` [nh, p, d], ``A_log``, ``D``, ``dt_bias`` [nh], ``conv_x``
[cw, nh, p], ``conv_b``/``conv_c`` [cw, n], ``norm``; ``ssd_specs``
gives their logical axes.

Under a mesh of more than one rank whose rules split ``SSD_HEADS``
(``ssd_tp``: the heads divide ``model``), each rank holds its heads of
the ``z``, ``x``, ``dt``, ``A_log``, ``D``, ``dt_bias``, ``conv_x`` and
``o`` leaves and runs the block on them, where JAX's ``shd.constrain``
lets GSPMD split it: the head projections take the block input through
``copy_to``; ``B``, ``C`` and their convolutions are replicated (one
group for every head), and their outputs pass ``copy_to`` before the
scan, so that the gradient of those weights, and their share of the
input's, sums every rank's heads; the gated RMSNorm spans every head
(its mean of squares summed over ``model`` both ways, ``psum``), each
rank applying its slice of the replicated ``scale`` behind ``copy_to``,
which gives ``scale`` its whole gradient on every rank; ``o`` is
row-parallel, summed over ``model`` by the block itself. Attention keys
its own reduce on ``HEADS``, so the hybrid's mean of the two branches
is right whichever of them is split. Where the heads do not divide
``model`` the block runs whole on every rank (JAX's "SSM DP-only").
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models.layers import dense_apply, dense_init, \
    rmsnorm_apply, rmsnorm_init, row_parallel, tp


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, nheads, head_dim, state)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    nheads = d_inner // cfg.ssm.head_dim
    return d_inner, nheads, cfg.ssm.head_dim, cfg.ssm.state_size


def ssd_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device) -> dict:
    """The SSD block's parameters, drawn as the JAX ``ssd_init`` draws
    them (from torch's generator, so not the same numbers): fan-in normal
    projections, A = -exp(A_log) with A_log = log U[1, 16], dt_bias the
    inverse softplus of logU[1e-3, 1e-1], D = 1, and convolutions that
    pass their last tap through."""
    d = cfg.d_model
    _, nh, p, n = ssm_dims(cfg)
    cw = cfg.ssm.conv_width
    params = {
        "z": dense_init(generator, (d,), (nh, p), dtype, device),
        "x": dense_init(generator, (d,), (nh, p), dtype, device),
        "B": dense_init(generator, (d,), (n,), dtype, device),
        "C": dense_init(generator, (d,), (n,), dtype, device),
        "dt": dense_init(generator, (d,), (nh,), dtype, device),
        "o": dense_init(generator, (nh, p), (d,), dtype, device),
    }
    u01 = torch.rand((2, nh), generator=generator, dtype=torch.float32,
                     device=device)
    a_log = torch.log(1.0 + 15.0 * u01[0])
    u = torch.exp(math.log(1e-3)
                  + (math.log(1e-1) - math.log(1e-3)) * u01[1])
    dt_bias = u + torch.log(-torch.expm1(-u))
    conv = {}
    for name, shape in (("conv_x", (cw, nh, p)), ("conv_b", (cw, n)),
                        ("conv_c", (cw, n))):
        w = torch.zeros(shape, dtype=dtype, device=device)
        w[cw - 1] = 1.0
        conv[name] = w
    params.update(A_log=a_log.to(dtype), D=torch.ones((nh,), dtype=dtype,
                                                       device=device),
                  dt_bias=dt_bias.to(dtype), **conv,
                  norm=rmsnorm_init(nh * p, dtype, device))
    return params


def ssd_specs(cfg: ModelConfig) -> dict:
    """Logical axes of ``ssd_init``'s parameters, as JAX's ``ssd_init``
    gives them."""
    return {
        "z": {"w": (shd.FSDP, shd.SSD_HEADS, None)},
        "x": {"w": (shd.FSDP, shd.SSD_HEADS, None)},
        "B": {"w": (shd.FSDP, None)}, "C": {"w": (shd.FSDP, None)},
        "dt": {"w": (shd.FSDP, shd.SSD_HEADS)},
        "o": {"w": (shd.SSD_HEADS, None, shd.FSDP)},
        "A_log": (shd.SSD_HEADS,), "D": (shd.SSD_HEADS,),
        "dt_bias": (shd.SSD_HEADS,),
        "conv_x": (None, shd.SSD_HEADS, None), "conv_b": (None, None),
        "conv_c": (None, None), "norm": {"scale": (None,)},
    }


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: [B, S, ...chan], w: [cw, ...chan] -> same shape as u (causal),
    summed tap by tap in u's type as the JAX function sums."""
    cw = w.shape[0]
    s = u.shape[1]
    up = F.pad(u, (0, 0) * (u.dim() - 2) + (cw - 1, 0))
    out = torch.zeros_like(u)
    for i in range(cw):
        out = out + w[i] * up[:, i:i + s]
    return out


def _mean_square(y: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The mean of squares of ``y`` [..., c] (float32) over every rank's
    channels: this rank's sum, summed over ``axis`` forward and backward
    (each rank normalises its own heads by it), over the global count."""
    ss = col.psum(y.square().sum(-1, keepdim=True), mesh, axis)
    return ss / (y.shape[-1] * mesh.size(axis))


def _gated_norm(params, y: torch.Tensor, eps: float,
                cd: torch.dtype) -> torch.Tensor:
    """The RMSNorm of ``y`` [..., h, p] over all heads' h * p channels,
    as the JAX block normalises ``y.reshape(..., nh * p)``. Under
    ``ssd_tp`` the mean of squares spans every rank's heads
    (``_mean_square``) and this rank applies its slice of the replicated
    ``scale``."""
    shape = y.shape
    flat = y.reshape(*shape[:-2], shape[-2] * shape[-1])
    mesh, axis = tp(shd.SSD_HEADS)
    if axis is None:
        return rmsnorm_apply(params, flat, eps, cd).reshape(shape)
    n = flat.shape[-1]
    scale = col.copy_to(params["scale"], mesh, axis).narrow(
        0, mesh.index(axis) * n, n)
    yf = flat.float()
    out = yf * torch.rsqrt(_mean_square(yf, mesh, axis) + eps)
    return (out * scale.float()).to(cd).reshape(shape)


def ssd_scan(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: K7 for a CUDA tensor, its plain version (chunks of
    ``chunk``) for a CPU one.

    xdt: [b, s, h, p] (x pre-multiplied by dt); a: [b, s, h] (dt*A,
    negative); B, C: [b, s, n]. Returns (y [b, s, h, p] in xdt's type,
    final_state [b, h, p, n] float32). Differentiable in every input and
    output: the backward is ``ssd_scan_bwd``, by ``chunk``, on every
    device."""
    return ssd_scan_cuda(
        xdt.contiguous(), a.float().contiguous(),
        B.to(xdt.dtype).contiguous(), C.to(xdt.dtype).contiguous(),
        chunk=chunk,
        init_state=None if init_state is None
        else init_state.float().contiguous())


def ssd_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                init_state: Optional[torch.Tensor] = None,
                conv_state: Optional[dict] = None,
                return_state: bool = False):
    """Full mamba2 block over a sequence. x: [B, S, D].

    Returns (y, state_dict or None) where state_dict carries the SSM state
    ``ssm`` and the conv tail ``conv`` {``x``, ``B``, ``C``} for
    streaming or decode continuation. ``conv_state`` is such a tail,
    prepended so that the causal conv continues the stream."""
    cd = x.dtype
    _, nh, _, _ = ssm_dims(cfg)
    cw = cfg.ssm.conv_width
    s = x.shape[1]
    mesh, axis = tp(shd.SSD_HEADS)
    xh = col.copy_to(x, mesh, axis)         # into this rank's heads

    z = dense_apply(params["z"], xh, cd)                      # [B,S,H,P]
    xs = dense_apply(params["x"], xh, cd)
    Bp = dense_apply(params["B"], x, cd)                      # [B,S,N]
    Cp = dense_apply(params["C"], x, cd)
    dt = dense_apply(params["dt"], xh, torch.float32)         # [B,S,H]

    if conv_state is not None:
        xs = torch.cat([conv_state["x"].to(cd), xs], dim=1)
        Bp = torch.cat([conv_state["B"].to(cd), Bp], dim=1)
        Cp = torch.cat([conv_state["C"].to(cd), Cp], dim=1)
    xs_c = F.silu(_causal_depthwise_conv(xs, params["conv_x"].to(cd)))
    Bp_c = F.silu(_causal_depthwise_conv(Bp, params["conv_b"].to(cd)))
    Cp_c = F.silu(_causal_depthwise_conv(Cp, params["conv_c"].to(cd)))
    if conv_state is not None:
        xs_c, Bp_c, Cp_c = (t[:, -s:] for t in (xs_c, Bp_c, Cp_c))
    new_conv = None
    if return_state:
        tail = cw - 1
        new_conv = {"x": xs[:, -tail:], "B": Bp[:, -tail:],
                    "C": Cp[:, -tail:]}
    # every rank's heads read B and C: their gradient sums over the ranks
    Bp_c, Cp_c = col.copy_to(Bp_c, mesh, axis), col.copy_to(Cp_c, mesh, axis)
    xs_c = shd.constrain(xs_c, shd.BATCH, None, shd.SSD_HEADS, None,
                         full=(None, None, nh, None))

    dt = F.softplus(dt + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                  # [H]
    a = dt * A                                                # [B,S,H]
    xdt = xs_c * dt.to(cd)[..., None]

    y, state = ssd_scan(xdt, a, Bp_c, Cp_c, cfg.ssm.chunk_size,
                        init_state=init_state)
    y = y + params["D"].to(cd)[None, None, :, None] * xs_c
    y = _gated_norm(params["norm"], y * F.silu(z), cfg.norm_eps, cd)
    out = row_parallel(params["o"], y, cd, 2, mesh, axis)
    out = shd.constrain(out, shd.BATCH, None, None)
    if return_state:
        return out, {"ssm": state, "conv": new_conv}
    return out, None


def ssd_decode(params, x: torch.Tensor, cfg: ModelConfig, *, state: dict):
    """Single-token step. x: [B, 1, D]; state: {'ssm': [B,H,P,N],
    'conv': {'x': [B,cw-1,H,P], 'B': [B,cw-1,N], 'C': [B,cw-1,N]}}.
    Returns (y [B,1,D], new_state)."""
    cd = x.dtype
    mesh, axis = tp(shd.SSD_HEADS)

    z = dense_apply(params["z"], x, cd)[:, 0]                 # [B,H,P]
    xs = dense_apply(params["x"], x, cd)                      # [B,1,H,P]
    Bp = dense_apply(params["B"], x, cd)
    Cp = dense_apply(params["C"], x, cd)
    dt = dense_apply(params["dt"], x, torch.float32)[:, 0]    # [B,H]

    conv = state["conv"]
    x_win = torch.cat([conv["x"].to(cd), xs], dim=1)          # [B,cw,H,P]
    B_win = torch.cat([conv["B"].to(cd), Bp], dim=1)
    C_win = torch.cat([conv["C"].to(cd), Cp], dim=1)
    xc = F.silu(torch.einsum("bwhp,whp->bhp", x_win,
                             params["conv_x"].to(cd)))
    Bc = F.silu(torch.einsum("bwn,wn->bn", B_win, params["conv_b"].to(cd)))
    Cc = F.silu(torch.einsum("bwn,wn->bn", C_win, params["conv_c"].to(cd)))
    new_conv = {"x": x_win[:, 1:], "B": B_win[:, 1:], "C": C_win[:, 1:]}

    dt = F.softplus(dt + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt * A)                                 # [B,H]
    h = state["ssm"]                                          # [B,H,P,N] fp32
    upd = torch.einsum("bn,bhp,bh->bhpn", Bc.float(), xc.float(), dt)
    h_new = decay[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhpn->bhp", Cc.float(), h_new)
    y = y.to(cd) + params["D"].to(cd)[None, :, None] * xc
    y = _gated_norm(params["norm"], y * F.silu(z), cfg.norm_eps, cd)
    out = row_parallel(params["o"], y[:, None], cd, 2, mesh, axis)
    return out, {"ssm": h_new, "conv": new_conv}
