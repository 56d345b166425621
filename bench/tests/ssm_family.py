"""A block family that no cell uses, for the test that a family is added
as new files only: copied into a checkout as ``bench/reference/ssm.py``.
The Mamba-2 block (arXiv:2405.21060) alone, as the port's ``ssm`` family
has it: a pre-norm SSD block added to the residual, and the MLP only
where ``d_ff`` is set. The SSD block projects z, x, B, C and dt; x, B
and C pass a causal depthwise convolution and SiLU; dt = softplus(dt +
bias), A = -exp(A_log), and per head ``h_t = exp(dt_t A) h_{t-1} + dt_t
x_t B_t``, ``y_t = C_t . h_t + D x_t``, step by step; the output is gated
by SiLU(z), normed over all heads' channels and projected."""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from bench.reference.common import Precision, linear, rmsnorm
from bench.reference.dense import mlp, mlp_leaves
from bench.weights import Leaf, projection


def _uniform(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _dt_bias(z: torch.Tensor) -> torch.Tensor:
    """softplus(dt_bias) log-uniform in [1e-3, 1e-1]."""
    dt = torch.exp(math.log(1e-3) + math.log(100.0) * _uniform(z))
    return dt + torch.log(-torch.expm1(-dt))


def _conv(z: torch.Tensor) -> torch.Tensor:
    """The last tap near 1, the rest small."""
    w = z * 0.2
    w[-1] += 1.0
    return w


RULES = {"a_log": lambda z: torch.log(1.0 + 15.0 * _uniform(z)),
         "dt_bias": _dt_bias, "conv": _conv}


def leaves(cfg: dict) -> List[Leaf]:
    d, ssm = cfg["d_model"], cfg["ssm"]
    nh = ssm["expand"] * d // ssm["head_dim"]
    p, n, cw = ssm["head_dim"], ssm["state_size"], ssm["conv_width"]
    out: List[Leaf] = [("ln1.scale", (d,), ("one", 0.05))]
    out += projection("ssd.z", (d,), (nh, p), False)
    out += projection("ssd.x", (d,), (nh, p), False)
    out += projection("ssd.B", (d,), (n,), False)
    out += projection("ssd.C", (d,), (n,), False)
    out += projection("ssd.dt", (d,), (nh,), False)
    out += projection("ssd.o", (nh, p), (d,), False)
    out += [("ssd.A_log", (nh,), ("a_log",)),
            ("ssd.D", (nh,), ("one", 0.1)),
            ("ssd.dt_bias", (nh,), ("dt_bias",)),
            ("ssd.conv_x", (cw, nh, p), ("conv",)),
            ("ssd.conv_b", (cw, n), ("conv",)),
            ("ssd.conv_c", (cw, n), ("conv",)),
            ("ssd.norm.scale", (nh * p,), ("one", 0.05))]
    return out + (mlp_leaves(cfg) if cfg["d_ff"] else [])


def causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    cw, s = w.shape[0], u.shape[1]
    up = torch.cat([u.new_zeros((u.shape[0], cw - 1, *u.shape[2:])), u], 1)
    return sum(w[i] * up[:, i:i + s] for i in range(cw))


def ssd_branch(cfg: dict, p: dict, h: torch.Tensor, rnd: Precision
               ) -> torch.Tensor:
    z = linear(h, p["z"], rnd)
    xs = F.silu(causal_conv(linear(h, p["x"], rnd), p["conv_x"]))
    Bc = F.silu(causal_conv(linear(h, p["B"], rnd), p["conv_b"]))
    Cc = F.silu(causal_conv(linear(h, p["C"], rnd), p["conv_c"]))
    dt = F.softplus(linear(h, p["dt"], rnd) + p["dt_bias"])
    a = dt * -torch.exp(p["A_log"])
    xdt = xs * dt[..., None]
    b, s, nh, hp = xs.shape
    state = xs.new_zeros((b, nh, hp, Bc.shape[-1]))
    ys = []
    for t in range(s):
        state = torch.exp(a[:, t])[:, :, None, None] * state \
            + xdt[:, t, :, :, None] * Bc[:, t, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", Cc[:, t], state))
    y = torch.stack(ys, 1) + p["D"][None, None, :, None] * xs
    y = y * F.silu(z)
    y = rmsnorm(y.reshape(b, s, -1), p["norm"]["scale"],
                cfg["norm_eps"]).reshape(y.shape)
    return linear(y, p["o"], rnd, contract=2)


def layer(cfg: dict, p: dict, x: torch.Tensor, positions: torch.Tensor,
          rnd: Precision) -> torch.Tensor:
    x = x + ssd_branch(cfg, p["ssd"], rmsnorm(x, p["ln1"]["scale"],
                                               cfg["norm_eps"]), rnd)
    if "mlp" not in p:
        return x
    return x + mlp(cfg, p["mlp"], rmsnorm(x, p["ln2"]["scale"],
                                           cfg["norm_eps"]), rnd)
