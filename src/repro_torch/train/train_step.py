"""Train step factory: loss -> grad -> (optional transform) -> AdamW, as
the JAX package's ``train/train_step.py``.

``TrainState`` holds the parameters (a dict of tensors by name, as
``Model.init`` returns them) and the optimizer state; ``train_step``
updates both in place and returns the state. Every family the port
builds trains here (dense, MoE, SSM, hybrid, the frontends).

Under the ambient ``ShardCtx`` of a mesh of more than one rank (JAX's
``launch/dryrun.py`` runs its jitted step inside ``use_ctx``; the port's
step is called inside it), the state holds this rank's shards
(``Model.init`` under the context, or ``convert.shard_params_from_jax``),
the step takes the *global* batch and keeps this rank's rows of it (by
the batch axes; with micro-batches, its rows of each global micro-batch,
as a batch-sharded ``lax.scan`` carries them), and after the backward it
sums over the data-parallel axes the gradient of every parameter that is
not sharded on them (an FSDP-sharded one was reduce-scattered by its
gather's backward). A ``grad_transform`` then sees this rank's shards,
each tagged with the axes that split it (``compression.tag_shards``).
AdamW then clips by the global norm
(``replicas``: each replicated tensor counted once) and updates the
local shards and moments. ``make_train_state_specs``,
``choose_microbatches`` and ``choose_remat_group`` are the JAX
functions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import Model
from repro_torch.obs import lm
from repro_torch.train.compression import tag_shards
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update

METRICS = ("ce", "aux", "ntok", "loss")


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt: Dict[str, Any]


def init_train_state(model: Model, generator: torch.Generator) -> TrainState:
    params = model.init(generator)
    return TrainState(params=params, opt=adamw_init(params))


def make_train_state_specs(model: Model) -> TrainState:
    """Logical-axis spec tree matching TrainState structure."""
    pspecs = model.specs()
    return TrainState(params=pspecs,
                      opt={"m": pspecs, "v": pspecs, "step": ()})


def choose_microbatches(cfg, shape, mesh_cfg, profile,
                        act_budget_bytes: float = 2 << 30) -> int:
    """Pick gradient-accumulation depth so per-device live activations fit
    the budget. Two dominant terms per unit batch:
      * remat-scan residual carries: L x S x D x 2B
      * fp32 logits + grad + softmax workspace: S x Vp_loc x 4B x 3
    """
    axes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    n_batch = 1
    for ax in profile.batch_axes:
        n_batch *= axes[ax]
    b_shard = max(shape.global_batch // max(n_batch, 1), 1)
    vp_loc = shd.pad_vocab(cfg.vocab_size) // (
        axes.get("model", 1) if profile.vocab_tp else 1)
    per_unit = (cfg.num_layers * shape.seq_len * cfg.d_model * 2
                + shape.seq_len * vp_loc * 4 * 3)
    mu = 1
    while mu < b_shard and per_unit * (b_shard // mu) > act_budget_bytes:
        mu *= 2
    return mu


def choose_remat_group(cfg, shape, mesh_cfg, profile, mu,
                       carry_budget_bytes: float = 1 << 31) -> int:
    """If the flat per-layer carries still exceed the budget at the chosen
    microbatch depth, pick a sqrt-L remat group size (a divisor of L)."""
    axes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    n_batch = 1
    for ax in profile.batch_axes:
        n_batch *= axes[ax]
    b_mu = max(shape.global_batch // max(n_batch, 1) // mu, 1)
    carry = b_mu * shape.seq_len * cfg.d_model * 2
    if cfg.num_layers * carry <= carry_budget_bytes:
        return 0
    L = cfg.num_layers
    target = max(int(math.sqrt(L)), 2)
    best = 1
    for g in range(2, L + 1):
        if L % g == 0 and abs(g - target) < abs(best - target):
            best = g
    return best if best > 1 else 0


def local_batch(batch: Dict[str, torch.Tensor], ctx: shd.ShardCtx,
                num_microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: of each of the
    ``num_microbatches`` global micro-batches, the slice the batch axes
    give it (a-major for axes (a, b))."""
    axes = ctx.profile.batch_axes
    n, index = 1, 0
    for ax in axes:
        n *= ctx.mesh.size(ax)
        index = index * ctx.mesh.size(ax) + ctx.mesh.index(ax)
    out = {}
    for k, x in batch.items():
        rows = x.shape[0]
        if rows % (num_microbatches * n):
            raise ValueError(f"batch of {rows} does not split into "
                             f"{num_microbatches} micro-batches over {n} "
                             "shards")
        per = rows // (num_microbatches * n)
        out[k] = torch.cat([x[(i * n + index) * per:(i * n + index + 1) * per]
                            for i in range(num_microbatches)])
    return out


def grad_replicas(model: Model, ctx: Optional[shd.ShardCtx]
                  ) -> Optional[Dict[str, int]]:
    """Per parameter, how many ranks hold an equal copy of its shard (the
    world over the shards its pspec cuts it into): the global norm counts
    each once. None without a mesh."""
    if ctx is None:
        return None
    specs = model.specs()
    return {name: ctx.mesh.world // ctx.shards(_axes_of(ctx, spec))
            for name, spec in specs.items()}


def _axes_of(ctx: shd.ShardCtx, spec) -> tuple:
    return tuple(a for e in ctx.pspec(*spec) for a in shd.entry_axes(e))


def reduce_grads(grads: Dict[str, torch.Tensor], model: Model,
                 ctx: shd.ShardCtx) -> Dict[str, torch.Tensor]:
    """Sum each gradient over the data-parallel axes its parameter is not
    sharded on."""
    specs = model.specs()
    dp = [a for a in ctx.mesh.axes if a != shd.MODEL_AXIS]
    out = {}
    for name, g in grads.items():
        held = _axes_of(ctx, specs[name])
        out[name] = col.all_reduce(g, ctx.mesh,
                                   [a for a in dp if a not in held],
                                   kind="grad_all_reduce")
    return out


def make_train_step(model: Model, opt_cfg: Optional[OptConfig] = None,
                    grad_transform: Optional[Callable] = None,
                    num_microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    ``num_microbatches > 1``: the batch is split on the leading axis and
    the gradients are accumulated in fp32 over the micro-batches, then
    averaged, for one optimizer step per call.

    ``grad_transform(grads) -> grads`` is where gradient compression
    plugs in (``train/compression.py``), on the reduced gradients before
    AdamW, as in JAX. Under a mesh each gradient is this rank's shard,
    its ``shard_axes`` set to the mesh axes that split it, and the
    transform computes this rank's slice of the transform of the whole
    gradient (``compression.py``).

    Spans (``repro_torch.obs.lm``): ``train.step``, around ``train.fwd``
    (``model.loss``, a micro-batch's), ``train.bwd`` (the gradients;
    lent to autograd's device thread, so a recompute's spans and K6's
    nest in it), ``train.reduce``, ``train.transform`` and ``train.opt``
    (in ``adamw_update``)."""
    opt_cfg = opt_cfg or OptConfig()

    def grads_and_metrics(params, batch):
        with lm.span("train.fwd"):
            loss, metrics = model.loss(params, batch)
        with lm.span("train.bwd") as bwd, lm.TRACER.lend(bwd):
            grads = torch.autograd.grad(loss, list(params.values()))
        metrics = dict(metrics)
        metrics.setdefault("loss", loss.detach())
        return dict(zip(params, grads)), metrics

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with lm.span("train.step"):
            return step(state, batch)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        ctx = shd.mesh_ctx()
        if ctx is not None:
            batch = local_batch(batch, ctx, max(num_microbatches, 1))
        if num_microbatches <= 1:
            grads, metrics = grads_and_metrics(state.params, batch)
        else:
            mu = num_microbatches
            n = next(iter(batch.values())).shape[0]
            if n % mu:
                raise ValueError(f"batch of {n} does not split into {mu} "
                                 "micro-batches")
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in state.params.items()}
            dev = next(iter(state.params.values())).device
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in METRICS}
            for i in range(mu):
                mb = {k: x[i * (n // mu):(i + 1) * (n // mu)]
                      for k, x in batch.items()}
                g, m = grads_and_metrics(state.params, mb)
                for k in grads:
                    grads[k] += g[k].float()
                del g
                for k in metrics:
                    metrics[k] = metrics[k] + m[k]
            grads = {k: g / mu for k, g in grads.items()}
            metrics = {k: m / mu for k, m in metrics.items()}
        if ctx is not None:
            with lm.span("train.reduce"):
                grads = reduce_grads(grads, model, ctx)
        if grad_transform is not None:
            with lm.span("train.transform"):
                if ctx is not None:
                    specs = model.specs()
                    tag_shards(grads, {n: _axes_of(ctx, specs[n])
                                       for n in grads})
                grads = grad_transform(grads)
        params, opt, stats = adamw_update(
            opt_cfg, state.params, grads, state.opt,
            replicas=grad_replicas(model, ctx),
            mesh=None if ctx is None else ctx.mesh)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(stats)
        return TrainState(params=params, opt=opt), metrics

    return train_step
