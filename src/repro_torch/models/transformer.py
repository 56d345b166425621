"""Model assembly for the dense family: the JAX package's
``models/transformer.py`` for ``FAMILY_DENSE`` (train forward and loss,
``transformer.py:308-370``).

Layers are an ``nn.ModuleList`` driven by a Python loop, in place of the
``lax.scan`` over stacked parameters; each layer's parameters are an
``nn.ModuleDict`` tree named as the JAX tree (``layers.3.attn.q.w`` is
layer 3 of the JAX ``layers/attn/q/w``). ``train_logits`` and ``loss`` take
the parameters as a mapping of those names to tensors, as the JAX
functions take their tree, so a gradient is taken with respect to whatever
the caller hands in (``None`` means the model's own).

``remat="full"`` wraps each layer in ``torch.utils.checkpoint``
(non-reentrant): the backward recomputes the layer, so K5 runs twice per
layer and step, and K6 once. ``"none"`` runs plain. ``"dots"`` and
``remat_group > 1`` raise, as do the other families, ``kv_repeat != 1``
and the serving half (``prefill``, ``decode_step``, ``init_cache``), which
come in later slices.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import FAMILY_DENSE, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as lyr

REMAT = ("none", "full")


def _layer_init(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, device) -> dict:
    """One dense decoder layer's parameters."""
    return {"ln1": lyr.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn_mod.attn_init(generator, cfg, dtype, device),
            "ln2": lyr.rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": lyr.mlp_init(generator, cfg, dtype, device)}


def _layer_forward(lp, x: torch.Tensor, *, cfg: ModelConfig,
                   positions: torch.Tensor, window: int) -> torch.Tensor:
    """One dense layer over the full sequence: attention, then the MLP,
    each on an RMS-normed input and added to the residual."""
    cd = x.dtype
    h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
    a_out, _ = attn_mod.attn_forward(lp["attn"], h, cfg, positions=positions,
                                     causal=True, window=window)
    x = x + a_out
    h2 = lyr.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps, cd)
    return x + lyr.mlp_apply(lp["mlp"], h2, cfg, cd)


def _module(tree: dict) -> nn.Module:
    """A parameter tree as modules: a dict of tensors is an
    ``nn.ParameterDict``, a dict of dicts an ``nn.ModuleDict``."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


class Model(nn.Module):
    """The dense transformer of one config, on one device.

    ``causal_skip`` is accepted and has nothing to switch: K5 and K6
    always skip the tiles that the causal mask empties. The JAX serving
    options ``kv_cache_bits`` and ``kv_dus_write`` only take their
    defaults here."""

    def __init__(self, cfg: ModelConfig, kv_repeat: int = 1,
                 remat_group: int = 0, causal_skip: bool = False,
                 kv_cache_bits: int = 16, kv_dus_write: bool = False,
                 device=None):
        super().__init__()
        if cfg.family != FAMILY_DENSE:
            raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                      "(only the dense family is)")
        if cfg.remat not in REMAT:
            raise NotImplementedError(f"remat={cfg.remat!r} is not ported "
                                      f"(one of {REMAT})")
        if remat_group > 1:
            raise NotImplementedError("two-level remat (remat_group > 1) "
                                      "is not ported")
        if kv_repeat != 1:
            raise NotImplementedError("kv_repeat != 1 (tensor-parallel K/V "
                                      "repeat) is not ported")
        if kv_cache_bits != 16 or kv_dus_write:
            raise NotImplementedError("the serving cache options "
                                      "(kv_cache_bits, kv_dus_write) come "
                                      "with the serving half of Model")
        self.cfg = cfg
        self.causal_skip = causal_skip
        self.device = resolve_device(device)
        self.embed = nn.ParameterDict()
        self.layers = nn.ModuleList()
        self.final_norm = nn.ParameterDict()

    # -------------------------------------------------- init
    def init(self, generator: torch.Generator) -> Dict[str, nn.Parameter]:
        """Draw the parameters from ``generator`` (on the model's device)
        into the model, and return them by name. The draws are not the JAX
        package's (``jax.random`` and torch differ): tests carry JAX
        weights across with ``convert.model_params_from_jax``."""
        cfg, dev = self.cfg, self.device
        dtype = lyr.dtype_of(cfg.param_dtype)
        self.embed = _module(lyr.embed_init(generator, cfg, dtype, dev))
        self.layers = nn.ModuleList(
            _module(_layer_init(generator, cfg, dtype, dev))
            for _ in range(cfg.num_layers))
        self.final_norm = _module(lyr.rmsnorm_init(cfg.d_model, dtype, dev))
        return dict(self.named_parameters())

    # -------------------------------------------------- train forward
    def train_logits(self, params: Optional[Mapping[str, torch.Tensor]],
                     batch) -> tuple:
        """Teacher-forced forward. Returns (logits fp32 [B,S,Vp], aux)."""
        cfg = self.cfg
        p = dict(self.named_parameters()) if params is None else params
        cd = lyr.dtype_of(cfg.compute_dtype)
        tokens = batch["tokens"]
        x = lyr.embed_apply({"table": p["embed.table"]}, tokens, cd)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        fn = functools.partial(_layer_forward, cfg=cfg, positions=positions,
                               window=cfg.attn_window)
        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            lp = lyr.nest({k[len(pre):]: v for k, v in p.items()
                           if k.startswith(pre)})
            if cfg.remat == "full":
                x = checkpoint(fn, lp, x, use_reentrant=False)
            else:
                x = fn(lp, x)
        x = lyr.rmsnorm_apply({"scale": p["final_norm.scale"]}, x,
                              cfg.norm_eps, cd)
        embed = {k[len("embed."):]: v for k, v in p.items()
                 if k.startswith("embed.")}
        logits = lyr.unembed_apply(embed, x, cfg)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params: Optional[Mapping[str, torch.Tensor]],
             batch) -> tuple:
        """Mean CE over targets >= 0 (+ aux). Returns (loss, metrics)."""
        logits, aux = self.train_logits(params, batch)
        targets = batch["targets"].long()
        mask = (targets >= 0).float()
        tgt = targets.clamp(min=0)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
        ce = (logz - gold) * mask
        ntok = mask.sum().clamp(min=1.0)
        loss = ce.sum() / ntok + aux
        return loss, {"ce": ce.sum() / ntok, "aux": aux, "ntok": ntok}

    # -------------------------------------------------- serving
    def init_cache(self, batch_size: int, cache_len: int):
        raise NotImplementedError("the decode cache comes with the serving "
                                  "half of Model")

    def prefill(self, params, batch, max_len: Optional[int] = None):
        raise NotImplementedError("prefill comes with the serving half of "
                                  "Model")

    def decode_step(self, params, tokens, cache):
        raise NotImplementedError("decode_step comes with the serving half "
                                  "of Model")
