"""build_model + input_specs: the public model-construction API.

``input_specs(cfg, shape)`` returns ``(batch, batch_logical_specs)``:
an empty tensor for every model input of one (arch, shape) cell, on
``device`` (on ``meta`` a shape that costs nothing), with the logical
axes that shard it, as the JAX package's ``models/model.py`` gives its
ShapeDtypeStruct stand-ins for the multi-pod dry-run
(``launch/dryrun.py``). Modality frontends (vlm/audio) are STUBS:
precomputed patch/frame embeddings appear directly in the batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (
    FAMILY_AUDIO, FAMILY_ENCDEC, FAMILY_VLM, ModelConfig, ShapeConfig,
)
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import dtype_of
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                model: Optional[Model] = None, device=None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Empty tensors on ``device`` (``None``: the model's, or the card)
    and logical axis specs for one (arch, shape) cell.

    train  : full batch with targets
    prefill: prompt batch (no targets)
    decode : single token + zeroed cache of seq_len capacity

    The batch is the global one, as the steps take it. The decode cache
    is ``model.init_cache``'s: under the ambient mesh context this rank's
    piece of each leaf by ``cache_specs``."""
    model = model or build_model(cfg, device=device)
    dev = model.device if device is None else torch.device(device)
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}

    def add_frontend():
        f = cfg.frontend_tokens
        cd = dtype_of(cfg.compute_dtype)
        if cfg.family == FAMILY_VLM:
            batch["patch_embeds"] = torch.empty((b, f, cfg.d_model),
                                                dtype=cd, device=dev)
            specs["patch_embeds"] = (shd.BATCH, None, None)
        elif cfg.family in (FAMILY_AUDIO, FAMILY_ENCDEC):
            batch["frame_embeds"] = torch.empty((b, f, cfg.d_model),
                                                dtype=cd, device=dev)
            specs["frame_embeds"] = (shd.BATCH, None, None)

    if shape.kind in ("train", "prefill"):
        text_len = s
        if cfg.family == FAMILY_VLM:
            text_len = s - cfg.frontend_tokens
        add_frontend()
        batch["tokens"] = torch.empty((b, text_len), dtype=torch.int32,
                                      device=dev)
        specs["tokens"] = (shd.BATCH, None)
        if shape.kind == "train":
            batch["targets"] = torch.empty((b, text_len), dtype=torch.int32,
                                           device=dev)
            specs["targets"] = (shd.BATCH, None)
        return batch, specs

    # decode: one new token against a cache of capacity seq_len
    batch["tokens"] = torch.empty((b, 1), dtype=torch.int32, device=dev)
    specs["tokens"] = (shd.BATCH, None)
    batch["cache"] = model.init_cache(b, s)
    specs["cache"] = model.cache_specs()
    return batch, specs
