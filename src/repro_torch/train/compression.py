"""Gradient compression with error feedback, as the JAX package's
``train/compression.py``.

int8 and top-k round trips with an error-feedback accumulator (Seide et
al. 2014; Karimireddy et al. 2019): the quantization residual is carried
into the next step. The compress -> decompress round trip reproduces the
numbers a wire format would carry; ``make_train_step``'s
``grad_transform`` is where it plugs in. Gradients and the error
feedback are dicts of tensors keyed as the parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


def _int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with one scale per tensor (its largest |x| / 127),
    rounded half to even as ``jnp.round``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _topk_roundtrip(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the elements whose |x| is at least the k-th largest |x|
    (k = frac of them, at least 1; ties at the threshold kept), zero the
    rest."""
    flat = x.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(flat.abs() >= thresh, flat,
                       torch.zeros((), dtype=flat.dtype,
                                   device=flat.device)).reshape(x.shape)


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
    """Returns (decompressed grads as sent on the wire, new EF state)."""
    if cfg.kind == "none":
        return grads, ef
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)
    sent, new_ef = {}, {}
    for k, g in grads.items():
        g = g.float()
        target = g + ef[k] if cfg.error_feedback else g
        out = _int8_roundtrip(target) if cfg.kind == "int8" \
            else _topk_roundtrip(target, cfg.topk_frac)
        sent[k] = out
        new_ef[k] = target - out if cfg.error_feedback else ef[k]
    return sent, new_ef


def compression_ratio(cfg: CompressorConfig) -> float:
    """Wire-bytes ratio vs fp32 (for the collective-roofline term)."""
    if cfg.kind == "int8":
        return 0.25
    if cfg.kind == "topk":
        return cfg.topk_frac * 2.0          # value + index
    return 1.0
