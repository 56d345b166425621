"""Train step factory: loss -> grad -> (optional transform) -> AdamW, as
the JAX package's ``train/train_step.py``.

``TrainState`` holds the parameters (a dict of tensors by name, as
``Model.init`` returns them) and the optimizer state; ``train_step``
updates both in place and returns the state. Every family the port
builds trains here (dense, MoE, SSM, hybrid). The JAX ``choose_microbatches``
and ``choose_remat_group`` read multi-device mesh profiles and come with the
multi-device work; ``make_train_state_specs`` belongs to sharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update

METRICS = ("ce", "aux", "ntok", "loss")


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt: Dict[str, Any]


def init_train_state(model: Model, generator: torch.Generator) -> TrainState:
    params = model.init(generator)
    return TrainState(params=params, opt=adamw_init(params))


def make_train_step(model: Model, opt_cfg: Optional[OptConfig] = None,
                    grad_transform: Optional[Callable] = None,
                    num_microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    ``num_microbatches > 1``: the batch is split on the leading axis and
    the gradients are accumulated in fp32 over the micro-batches, then
    averaged, for one optimizer step per call.

    ``grad_transform(grads) -> grads`` is where gradient compression
    plugs in (``train/compression.py``)."""
    opt_cfg = opt_cfg or OptConfig()

    def grads_and_metrics(params, batch):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        return dict(zip(params, grads)), metrics

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
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
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt, stats = adamw_update(opt_cfg, state.params, grads,
                                          state.opt)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(stats)
        return TrainState(params=params, opt=opt), metrics

    return train_step
