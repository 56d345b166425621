"""Gradient compression with error feedback, as the JAX package's
``train/compression.py``.

int8 and top-k round trips with an error-feedback accumulator (Seide et
al. 2014; Karimireddy et al. 2019): the quantization residual is carried
into the next step. The compress -> decompress round trip reproduces the
numbers a wire format would carry; ``make_train_step``'s
``grad_transform`` is where it plugs in. Gradients and the error
feedback are dicts of tensors keyed as the parameters.

A round trip takes one tensor of the JAX tree at a time, and JAX stacks
the layers of a model on a leading axis: ``layers/attn/q/w`` is one
array for every layer, with one int8 scale and one top-k threshold. The
port keeps one tensor a layer (``layers.3.attn.q.w``), so
``compress_grads`` and ``int8_leaves`` transform the layers of a stacked
name together (``leaves``): the scale is the largest |g| over all of
them, and top-k keeps the k largest of all of them.

Under a mesh of more than one rank (the ambient ``ShardCtx``) a gradient
is this rank's shard of the global, reduced gradient that JAX transforms,
and each rank computes its slice of the transform of the whole tensor:
the int8 scale is the largest |g| of the whole tensor (a ``max``
all-reduce over the mesh axes that split it), the top-k threshold the
k-th largest |g| of the whole tensor (every shard's own k largest,
gathered, then the k-th largest of those), and the error feedback stays
sharded as its parameter. The train step names each gradient's split
axes in its ``shard_axes`` attribute (``tag_shards``) before it calls the
transform, so that ``grad_transform(grads)`` is the same call on one
device and on a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import STACKED

#: the attribute that names the mesh axes a gradient tensor is split over
SHARD_AXES = "shard_axes"


def tag_shards(grads: Dict[str, torch.Tensor],
               axes: Dict[str, Tuple[str, ...]]) -> Dict[str, torch.Tensor]:
    """Set each gradient's ``shard_axes`` to the axes its parameter is
    split over; returns ``grads``."""
    for k, g in grads.items():
        setattr(g, SHARD_AXES, tuple(axes[k]))
    return grads


def leaves(names) -> Dict[str, List[str]]:
    """The names by the JAX leaf that holds them: every layer of a stacked
    head under one key (``layers.3.attn.q.w`` under ``layers.attn.q.w``),
    every other name alone, in the order of ``names``."""
    out: Dict[str, List[str]] = {}
    for name in names:
        head, _, rest = name.partition(".")
        index, _, leaf = rest.partition(".")
        key = f"{head}.{leaf}" if head in STACKED and index.isdigit() \
            else name
        out.setdefault(key, []).append(name)
    return out


def _split(x: torch.Tensor, axes: Optional[Sequence[str]]):
    """(mesh, the axes of size > 1 that split ``x``, the number of
    shards): ``axes``, or ``x``'s ``shard_axes``, under the ambient
    mesh."""
    axes = getattr(x, SHARD_AXES, ()) if axes is None else tuple(axes)
    ctx = shd.mesh_ctx()
    if not axes or ctx is None:
        return None, (), 1
    axes = tuple(a for a in axes if ctx.mesh.size(a) > 1)
    return ctx.mesh, axes, ctx.shards(axes)


def _int8_group(xs: List[torch.Tensor],
                axes: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """The int8 round trip of the tensors ``xs`` of one JAX leaf, by one
    scale: their largest |x| (of the whole tensors, where they are shards
    split over ``axes``; default: their ``shard_axes``) / 127, rounded
    half to even as ``jnp.round``."""
    mesh, axes, _ = _split(xs[0], axes)
    amax = torch.stack([x.abs().max() for x in xs]).max()
    if axes:
        amax = col.all_reduce(amax, mesh, axes, op="max",
                              kind="compress_max")
    scale = amax / 127.0 + 1e-12
    return [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            .to(torch.float32) * scale for x in xs]


def _topk_group(xs: List[torch.Tensor], frac: float,
                axes: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """The top-k round trip of the tensors ``xs`` of one JAX leaf: keep
    the elements whose |x| is at least the k-th largest of all of them
    (k = frac of their count, at least 1; ties at the threshold kept),
    zero the rest. Shards split over ``axes`` (default: their
    ``shard_axes``): k and the threshold of the whole tensors."""
    mesh, axes, shards = _split(xs[0], axes)
    mag = torch.cat([x.reshape(-1) for x in xs]).abs()
    k = max(int(mag.shape[0] * shards * frac), 1)
    if axes:
        # the whole tensors' k largest are among every shard's own k
        mag = col.all_gather(torch.topk(mag, min(k, mag.shape[0])).values,
                             mesh, axes, 0)
    thresh = torch.topk(mag, k).values[-1]
    zero = torch.zeros((), dtype=xs[0].dtype, device=xs[0].device)
    return [torch.where(x.abs() >= thresh, x, zero) for x in xs]


def _int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with one scale per tensor (its largest |x| / 127):
    ``_int8_group`` of ``x`` alone."""
    return _int8_group([x])[0]


def _topk_roundtrip(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Top-k of ``x`` alone (``_topk_group``)."""
    return _topk_group([x], frac)[0]


def int8_leaves(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``jax.tree.map(_int8_roundtrip, grads)`` of the JAX tree (the
    ``grad_transform`` of JAX's ``launch/dryrun.py`` with
    ``compress_grads``): one scale for each JAX leaf."""
    out = {}
    for names in leaves(grads).values():
        out.update(zip(names, _int8_group([grads[n] for n in names])))
    return {k: out[k] for k in grads}


@dataclass(frozen=True)
class CompressorConfig:
    kind: str = "int8"           # 'int8' | 'topk' | 'none'
    topk_frac: float = 0.01
    error_feedback: bool = True


def init_error_feedback(params: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A float32 zero per parameter, keyed as ``params``."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_grads(cfg: CompressorConfig, grads: Dict[str, torch.Tensor],
                   ef: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """Returns (decompressed grads as sent on the wire, new EF state); the
    layers of a stacked JAX leaf are transformed together."""
    if cfg.kind == "none":
        return grads, ef
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)
    sent, new_ef = {}, {}
    for names in leaves(grads).values():
        axes = getattr(grads[names[0]], SHARD_AXES, ())
        targets = [grads[k].float() + ef[k] if cfg.error_feedback
                   else grads[k].float() for k in names]
        outs = _int8_group(targets, axes) if cfg.kind == "int8" \
            else _topk_group(targets, cfg.topk_frac, axes)
        for k, target, out in zip(names, targets, outs):
            sent[k] = out
            new_ef[k] = target - out if cfg.error_feedback else ef[k]
    return {k: sent[k] for k in grads}, {k: new_ef[k] for k in grads}


def compression_ratio(cfg: CompressorConfig) -> float:
    """Wire-bytes ratio vs fp32 (for the collective-roofline term)."""
    if cfg.kind == "int8":
        return 0.25
    if cfg.kind == "topk":
        return cfg.topk_frac * 2.0          # value + index
    return 1.0
