"""AdamW with global-norm clipping and a linear-warmup cosine schedule,
the JAX package's ``train/optimizer.py`` line for line: the clip by the
global norm of all gradients, decoupled weight decay on matrices only
(``p.ndim >= 2``), moments in fp32.

The rule "matrices only" is the JAX one as the JAX tree meets it: there
each layer's leaf is stacked over the layers (the decoder's and the
encoder's), so a layer's norm scale or bias has rank 2 and decays; only
the unstacked vectors (the final norm's and ``enc_norm``'s scales) do
not. A port parameter named ``layers.<i>.*`` or ``encoder.<i>.*`` is one
slice of such a leaf, so its rank counts that axis (``jax_rank``), and
the two packages decay the same parameters.

Parameters and moments are dicts of tensors by name. ``adamw_update``
updates them in place (the JAX function returns new trees): at
starcoder2-7b's width the parameters and moments take tens of GB, and a
second copy would not fit. Every scalar stays a float32 tensor on the
parameters' device, so a step never waits on the host. Not
``torch.optim.AdamW``: its decay and its clipping are not this function.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.models.transformer import STACKED
from repro_torch.obs import lm



@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Mapping[str, torch.Tensor],
                replicas: Optional[Mapping[str, int]] = None,
                mesh=None) -> torch.Tensor:
    """The norm of every leaf together. Under a mesh the leaves are this
    rank's shards: the squares are summed over every rank, each divided by
    the number of ranks that hold an equal copy (``replicas``), so that a
    replicated tensor counts once."""
    if mesh is None:
        leaves = [x.float().square().sum() for x in tree.values()]
        return torch.stack(leaves).sum().sqrt()
    leaves = [x.float().square().sum() / replicas[n]
              for n, x in tree.items()]
    total = col.all_reduce(torch.stack(leaves).sum(), mesh, mesh.axes,
                           kind="norm_all_reduce")
    return total.sqrt()


def jax_rank(name: str, p: torch.Tensor) -> int:
    """The rank of the JAX leaf that parameter ``name`` is (a slice of):
    ``layers.<i>.*`` and ``encoder.<i>.*`` leaves are stacked over the
    layers there."""
    return p.ndim + (1 if name.split(".")[0] in STACKED else 0)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: dict,
                 replicas: Optional[Mapping[str, int]] = None, mesh=None
                 ) -> Tuple[Mapping[str, torch.Tensor], dict,
                            Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and the moments. Returns
    (params, opt_state, stats) as the JAX function does. Under a mesh
    (``mesh``, ``replicas``: ``global_norm``'s) the tensors are this
    rank's shards, and the moments are sharded as their parameters.
    Its span is ``train.opt``."""
    with lm.span("train.opt"):
        return _adamw(cfg, params, grads, opt_state, replicas, mesh)


def _adamw(cfg, params, grads, opt_state, replicas, mesh):
    gnorm = global_norm(grads, replicas, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.copy_(b1 * m.float() + (1 - b1) * g)
        v.copy_(b2 * v.float() + (1 - b2) * g.square())
        delta = (m.float() / bc1) / ((v.float() / bc2).sqrt() + cfg.eps)
        if jax_rank(name, p) >= 2:           # decoupled WD on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
