"""``build_model``: the public model-construction API.

The JAX package's ``input_specs`` (ShapeDtypeStruct stand-ins for the
multi-pod dry-run) belongs to the dry-run and is not ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Model


def build_model(cfg: ModelConfig, kv_repeat: int = 1,
                remat_group: int = 0, causal_skip: bool = False,
                kv_cache_bits: int = 16, kv_dus_write: bool = False,
                device=None) -> Model:
    """The model of ``cfg`` on ``device`` (``None``: the card), with no
    parameters until ``init``."""
    return Model(cfg=cfg, kv_repeat=kv_repeat, remat_group=remat_group,
                 causal_skip=causal_skip, kv_cache_bits=kv_cache_bits,
                 kv_dus_write=kv_dus_write, device=device)
