"""Model assembly for the dense, SSM and hybrid families: the JAX package's
``models/transformer.py`` for ``FAMILY_DENSE``, ``FAMILY_SSM`` (the
mamba2 SSD block only) and ``FAMILY_HYBRID`` (hymba: 0.5 * (attention +
SSD) in parallel, then the MLP), with its train forward and loss and its
serving half (``init_cache``, ``prefill``, ``prefill_streaming``,
``decode_step``).

Layers are an ``nn.ModuleList`` driven by a Python loop, in place of the
``lax.scan`` over stacked parameters; each layer's parameters are a module
tree named as the JAX tree (``layers.3.attn.q.w`` is layer 3 of the JAX
``layers/attn/q/w``). ``train_logits``, ``loss`` and the serving methods
take the parameters as a mapping of those names to tensors, as the JAX
functions take their tree (``None`` means the model's own).

``remat="full"`` wraps each layer in ``torch.utils.checkpoint``
(non-reentrant): the backward recomputes the layer, so K5 runs twice per
layer and step, and K6 once. ``"none"`` runs plain. ``"dots"`` and
``remat_group > 1`` raise, as do ``kv_repeat != 1`` and the other families
(MoE, VLM, audio, enc-dec). The SSD scan (K7) is forward-only, as the
Pallas kernel is, so the SSM and hybrid families run ``train_logits``
and ``loss`` but take no gradient; ``make_train_step`` refuses them.

The decode cache holds the JAX names, stacked on a leading layers axis:
``k``/``v`` [L, B, S_cache, Hkv, dh] (int8 with ``k_scale``/``v_scale``
[L, B, S_cache, Hkv] when ``kv_cache_bits=8``), ``ssm`` [L, B, H, P, N]
float32 and ``conv_x``/``conv_b``/``conv_c``, with ``pos`` a 0-dim int32
tensor. ``decode_step`` writes the new token's entries into the cache in
place and returns it with ``pos + 1`` (the JAX function returns a new
cache); clone a cache to keep it. ``kv_dus_write`` (the JAX per-shard
cache write) has nothing to switch on one card. The JAX ``cache_specs``
(logical shardings for the dry-run) has no counterpart here.

A window arch keeps the last ``window`` keys of a longer prompt in slots
``0..window-1`` and decodes position ``pos`` into slot ``pos % window``,
as the JAX package does: the ring is aligned only when the prompt length
is a multiple of the window (ROADMAP Queue 3).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import (
    FAMILY_DENSE, FAMILY_HYBRID, FAMILY_SSM, ModelConfig,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as lyr
from repro_torch.models import ssm as ssm_mod

REMAT = ("none", "full")
FAMILIES = (FAMILY_DENSE, FAMILY_SSM, FAMILY_HYBRID)


def _layer_init(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, device) -> dict:
    """One decoder layer's parameters for cfg.family."""
    params = {"ln1": lyr.rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.family in (FAMILY_DENSE, FAMILY_HYBRID):
        params["attn"] = attn_mod.attn_init(generator, cfg, dtype, device)
    if cfg.family in (FAMILY_SSM, FAMILY_HYBRID):
        params["ssd"] = ssm_mod.ssd_init(generator, cfg, dtype, device)
    if cfg.d_ff > 0:
        params["ln2"] = lyr.rmsnorm_init(cfg.d_model, dtype, device)
        params["mlp"] = lyr.mlp_init(generator, cfg, dtype, device)
    return params


def _layer_forward(lp, x: torch.Tensor, *, cfg: ModelConfig,
                   positions: torch.Tensor, window: int,
                   collect_kv: bool = False, collect_state: bool = False
                   ) -> Tuple[torch.Tensor, dict]:
    """One layer over the full sequence: attention and/or the SSD block on
    the RMS-normed input (their mean for the hybrid), added to the
    residual, then the MLP. Returns (x, collected): the post-RoPE K/V and
    the SSM state and conv tail, as asked."""
    cd = x.dtype
    collected: dict = {}
    h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
    delta = None
    if "attn" in lp:
        delta, kv = attn_mod.attn_forward(
            lp["attn"], h, cfg, positions=positions, causal=True,
            window=window, return_kv=collect_kv)
        if collect_kv:
            collected["k"], collected["v"] = kv
    if "ssd" in lp:
        s_out, state = ssm_mod.ssd_forward(lp["ssd"], h, cfg,
                                           return_state=collect_state)
        if collect_state:
            collected["ssm"] = state["ssm"]
            collected["conv_x"] = state["conv"]["x"]
            collected["conv_b"] = state["conv"]["B"]
            collected["conv_c"] = state["conv"]["C"]
        delta = s_out if delta is None else delta + s_out
    if "attn" in lp and "ssd" in lp:
        delta = delta * 0.5                 # hymba: mean of parallel heads
    x = x + delta
    if "mlp" in lp:
        h2 = lyr.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps, cd)
        x = x + lyr.mlp_apply(lp["mlp"], h2, cfg, cd)
    return x, collected


def _layer_x(lp, x, **kw) -> torch.Tensor:
    return _layer_forward(lp, x, **kw)[0]


def _layer_decode(lp, x: torch.Tensor, cfg: ModelConfig, *,
                  cache_layer: dict, cache_pos: int,
                  window: int) -> torch.Tensor:
    """Single-token layer step. ``cache_layer`` holds this layer's views
    of the stacked cache, which are updated in place."""
    cd = x.dtype
    h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
    delta = None
    if "attn" in lp:
        scales = None
        if "k_scale" in cache_layer:
            scales = (cache_layer["k_scale"], cache_layer["v_scale"])
        delta, _, _, _ = attn_mod.attn_decode(
            lp["attn"], h, cfg, cache_k=cache_layer["k"],
            cache_v=cache_layer["v"], cache_pos=cache_pos, window=window,
            kv_scales=scales)
    if "ssd" in lp:
        state = {"ssm": cache_layer["ssm"],
                 "conv": {"x": cache_layer["conv_x"],
                          "B": cache_layer["conv_b"],
                          "C": cache_layer["conv_c"]}}
        s_out, new = ssm_mod.ssd_decode(lp["ssd"], h, cfg, state=state)
        cache_layer["ssm"].copy_(new["ssm"])
        cache_layer["conv_x"].copy_(new["conv"]["x"])
        cache_layer["conv_b"].copy_(new["conv"]["B"])
        cache_layer["conv_c"].copy_(new["conv"]["C"])
        delta = s_out if delta is None else delta + s_out
    if "attn" in lp and "ssd" in lp:
        delta = delta * 0.5
    x = x + delta
    if "mlp" in lp:
        h2 = lyr.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps, cd)
        x = x + lyr.mlp_apply(lp["mlp"], h2, cfg, cd)
    return x


class _Params(nn.Module):
    """A parameter tree whose nodes hold tensors, subtrees or both (the
    SSD block's ``A_log`` beside its ``z.w``), named as the JAX tree."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, _Params(v))


class Model(nn.Module):
    """The dense, SSM or hybrid model of one config, on one device.

    ``causal_skip`` is accepted and has nothing to switch: K5 and K6
    always skip the tiles that the causal mask empties; nor has
    ``kv_dus_write`` on one card."""

    def __init__(self, cfg: ModelConfig, kv_repeat: int = 1,
                 remat_group: int = 0, causal_skip: bool = False,
                 kv_cache_bits: int = 16, kv_dus_write: bool = False,
                 device=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                      f"(of {FAMILIES})")
        if cfg.remat not in REMAT:
            raise NotImplementedError(f"remat={cfg.remat!r} is not ported "
                                      f"(one of {REMAT})")
        if remat_group > 1:
            raise NotImplementedError("two-level remat (remat_group > 1) "
                                      "is not ported")
        if kv_repeat != 1:
            raise NotImplementedError("kv_repeat != 1 (tensor-parallel K/V "
                                      "repeat) is not ported")
        if kv_cache_bits not in (8, 16):
            raise ValueError(f"kv_cache_bits must be 8 or 16, got "
                             f"{kv_cache_bits}")
        self.cfg = cfg
        self.causal_skip = causal_skip
        self.kv_cache_bits = kv_cache_bits
        self.kv_dus_write = kv_dus_write
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
        self.embed = _Params(lyr.embed_init(generator, cfg, dtype, dev))
        self.layers = nn.ModuleList(
            _Params(_layer_init(generator, cfg, dtype, dev))
            for _ in range(cfg.num_layers))
        self.final_norm = _Params(lyr.rmsnorm_init(cfg.d_model, dtype, dev))
        return dict(self.named_parameters())

    def _split(self, params: Optional[Mapping[str, torch.Tensor]]
               ) -> Tuple[dict, List[dict], dict]:
        """(embed, one nested tree per layer, final_norm) of ``params``
        (``None``: the model's own)."""
        p = dict(self.named_parameters()) if params is None else params
        embed, final = {}, {}
        layers: List[dict] = [{} for _ in range(self.cfg.num_layers)]
        for name, t in p.items():
            head, _, rest = name.partition(".")
            if head == "layers":
                i, _, leaf = rest.partition(".")
                layers[int(i)][leaf] = t
            elif head == "embed":
                embed[rest] = t
            elif head == "final_norm":
                final[rest] = t
        return embed, [lyr.nest(lp) for lp in layers], final

    def _head(self, embed: dict, final: dict, x: torch.Tensor,
              cd: torch.dtype) -> torch.Tensor:
        x = lyr.rmsnorm_apply(final, x, self.cfg.norm_eps, cd)
        return lyr.unembed_apply(embed, x, self.cfg)

    # -------------------------------------------------- train forward
    def train_logits(self, params: Optional[Mapping[str, torch.Tensor]],
                     batch) -> tuple:
        """Teacher-forced forward. Returns (logits fp32 [B,S,Vp], aux)."""
        cfg = self.cfg
        embed, layers, final = self._split(params)
        cd = lyr.dtype_of(cfg.compute_dtype)
        tokens = batch["tokens"]
        x = lyr.embed_apply(embed, tokens, cd)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        fn = functools.partial(_layer_x, cfg=cfg, positions=positions,
                               window=cfg.attn_window)
        for lp in layers:
            if cfg.remat == "full":
                x = checkpoint(fn, lp, x, use_reentrant=False)
            else:
                x = fn(lp, x)
        logits = self._head(embed, final, x, cd)
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
    def cache_len_for(self, seq_len: int) -> int:
        if self.cfg.attn_window:
            return min(seq_len, self.cfg.attn_window)
        return seq_len

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """Zeroed decode cache on the model's device."""
        cfg, dev = self.cfg, self.device
        cd = lyr.dtype_of(cfg.compute_dtype)
        L, b = cfg.num_layers, batch_size
        layers: Dict[str, torch.Tensor] = {}
        if cfg.has_attention:
            hs, dh = cfg.num_kv_heads, cfg.resolved_head_dim
            s_c = self.cache_len_for(cache_len)
            kv_dtype = torch.int8 if self.kv_cache_bits == 8 else cd
            for name in ("k", "v"):
                layers[name] = torch.zeros((L, b, s_c, hs, dh),
                                           dtype=kv_dtype, device=dev)
            if self.kv_cache_bits == 8:
                for name in ("k_scale", "v_scale"):
                    layers[name] = torch.zeros((L, b, s_c, hs), dtype=cd,
                                               device=dev)
        if cfg.ssm.enabled:
            _, nh, p, n = ssm_mod.ssm_dims(cfg)
            cw = cfg.ssm.conv_width
            layers["ssm"] = torch.zeros((L, b, nh, p, n),
                                        dtype=torch.float32, device=dev)
            layers["conv_x"] = torch.zeros((L, b, cw - 1, nh, p), dtype=cd,
                                           device=dev)
            for name in ("conv_b", "conv_c"):
                layers[name] = torch.zeros((L, b, cw - 1, n), dtype=cd,
                                           device=dev)
        return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
                "layers": layers}

    @torch.no_grad()
    def prefill(self, params: Optional[Mapping[str, torch.Tensor]], batch,
                max_len: Optional[int] = None):
        """Process a prompt, return (last-token logits [B,1,Vp] fp32,
        filled cache).

        ``max_len``: cache capacity to allocate (>= prompt length) so
        subsequent ``decode_step`` calls have room; defaults to prompt
        length + 1. A window arch keeps the last ``window`` keys of a
        longer prompt in slots ``0..window-1``."""
        cfg = self.cfg
        cd = lyr.dtype_of(cfg.compute_dtype)
        embed, layers, final = self._split(params)
        tokens = batch["tokens"]
        x = lyr.embed_apply(embed, tokens, cd)
        b, s = tokens.shape
        cap = max_len if max_len is not None else s + 1
        if cap < s and not cfg.attn_window:
            raise ValueError(f"prefill cache capacity {cap} < prompt "
                             f"embedding length {s}")
        cache = self.init_cache(b, cap)
        cl = cache["layers"]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        for i, lp in enumerate(layers):
            x, coll = _layer_forward(
                lp, x, cfg=cfg, positions=positions, window=cfg.attn_window,
                collect_kv=cfg.has_attention, collect_state=cfg.ssm.enabled)
            if cfg.has_attention:
                self._fill_kv(cl, i, coll["k"], coll["v"], s)
            if cfg.ssm.enabled:
                cl["ssm"][i] = coll["ssm"]
                for name in ("conv_x", "conv_b", "conv_c"):
                    cl[name][i] = coll[name].to(cd)
        logits = self._head(embed, final, x[:, -1:], cd)
        cache["pos"].fill_(s)
        return logits, cache

    def _fill_kv(self, cl: dict, i: int, k: torch.Tensor, v: torch.Tensor,
                 s: int) -> None:
        """Layer ``i``'s prompt K/V [B, S, Hkv, dh] into the cache: all of
        them, or the last S_cache of a window arch's longer prompt."""
        s_c = cl["k"].shape[2]
        lo = s - s_c if s_c < s else 0
        n = min(s, s_c)
        for name, t in (("k", k), ("v", v)):
            if self.kv_cache_bits == 8:
                t, scale = attn_mod._quantize_kv(t)
                cl[f"{name}_scale"][i, :, :n] = scale[:, lo:].to(
                    cl[f"{name}_scale"].dtype)
            cl[name][i, :, :n] = t[:, lo:].to(cl[name].dtype)

    @torch.no_grad()
    def prefill_streaming(self, params: Optional[Mapping[str, torch.Tensor]],
                          batch, chunk: int = 4096):
        """SSM-family chunked prefill: process an arbitrarily long prompt
        in fixed-size chunks carrying the SSM state (through K7's
        ``init_state``) and the conv tail between them, so that peak
        activation memory is O(chunk). Returns (last-token logits,
        decode-ready cache)."""
        cfg = self.cfg
        if cfg.family != FAMILY_SSM:
            raise ValueError("streaming prefill is SSM-only")
        cd = lyr.dtype_of(cfg.compute_dtype)
        embed, layers, final = self._split(params)
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s % chunk and s >= chunk:
            raise ValueError("prompt length must be a multiple of the chunk")
        chunk = min(chunk, s)
        cache = self.init_cache(b, 1)
        cl = cache["layers"]
        x = None
        for c0 in range(0, s, chunk):
            x = lyr.embed_apply(embed, tokens[:, c0:c0 + chunk], cd)
            for i, lp in enumerate(layers):
                h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
                out, st = ssm_mod.ssd_forward(
                    lp["ssd"], h, cfg, init_state=cl["ssm"][i],
                    conv_state={"x": cl["conv_x"][i], "B": cl["conv_b"][i],
                                "C": cl["conv_c"][i]},
                    return_state=True)
                x = x + out
                cl["ssm"][i] = st["ssm"]
                cl["conv_x"][i] = st["conv"]["x"].to(cd)
                cl["conv_b"][i] = st["conv"]["B"].to(cd)
                cl["conv_c"][i] = st["conv"]["C"].to(cd)
        logits = self._head(embed, final, x[:, -1:], cd)
        cache["pos"].fill_(s)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params: Optional[Mapping[str, torch.Tensor]],
                    tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] -> (logits [B,1,Vp] fp32, the cache with this
        token written in place and ``pos + 1``)."""
        cfg = self.cfg
        cd = lyr.dtype_of(cfg.compute_dtype)
        embed, layers, final = self._split(params)
        x = lyr.embed_apply(embed, tokens, cd)
        pos = int(cache["pos"])
        cl = cache["layers"]
        for i, lp in enumerate(layers):
            x = _layer_decode(lp, x, cfg,
                              cache_layer={k: t[i] for k, t in cl.items()},
                              cache_pos=pos, window=cfg.attn_window)
        logits = self._head(embed, final, x, cd)
        cache["pos"] = torch.full((), pos + 1, dtype=torch.int32,
                                  device=cache["pos"].device)
        return logits, cache
