"""Model assembly for every family of the JAX package's
``models/transformer.py``: ``FAMILY_DENSE``, ``FAMILY_MOE`` (attention,
then the mixture-of-experts FFN of ``models/moe.py`` in place of the
MLP), ``FAMILY_SSM`` (the mamba2 SSD block only), ``FAMILY_HYBRID``
(hymba: 0.5 * (attention + SSD) in parallel, then the MLP),
``FAMILY_VLM`` (the dense decoder behind a prefix of stub patch
embeddings, ``batch["patch_embeds"]``, at positions 0..F-1) and
``FAMILY_ENCDEC`` / ``FAMILY_AUDIO`` (a bidirectional encoder over stub
frame embeddings, ``batch["frame_embeds"]``, then a causal decoder whose
layers add a cross-attention block after self-attention), with its train
forward and loss and its serving half (``init_cache``, ``prefill``,
``prefill_streaming``, ``decode_step``).

Layers are an ``nn.ModuleList`` driven by a Python loop, in place of the
``lax.scan`` over stacked parameters; each layer's parameters are a module
tree named as the JAX tree (``layers.3.attn.q.w`` is layer 3 of the JAX
``layers/attn/q/w``, ``encoder.1.mlp.up.w`` encoder layer 1 of
``encoder/mlp/up/w``). ``train_logits``, ``loss`` and the serving methods
take the parameters as a mapping of those names to tensors, as the JAX
functions take their tree (``None`` means the model's own); a name under
no head of the tree raises.

The encoder runs ``encoder_layers`` layers of the family's block
(attention non-causal and unwindowed, then the MLP) over the frames at
positions 0..F-1, each under ``remat`` as a decoder layer is (never
regrouped by ``remat_group``), then ``enc_norm``. ``_cross_kv`` projects
its output once into every decoder layer's cross K/V (K RoPE'd at the
encoder's positions, both repeated by ``kv_repeat``); the decoder's
cross-attention attends them through K5/K6 from q at the decoder's
positions, and their gradient reaches the encoder through K6's dK/dV.
The VLM's ``loss`` scores the text tail only: its logits cover the patch
positions too.

Each layer returns its aux loss (the MoE router's; 0 for the other
families), and ``train_logits`` sums it over the layers as the JAX scan
carries it; ``prefill`` and ``decode_step`` discard it.

``remat="full"`` wraps each layer in ``torch.utils.checkpoint``
(non-reentrant): the backward recomputes the layer, so K5 and K7 run
twice per layer and step, and K6 once. ``"dots"`` is JAX's
``checkpoint_dots``: the same checkpoint with a selective policy that
saves the outputs of the matrix products (``aten.mm``, ``bmm``,
``addmm``, ``baddbmm``, which an ``einsum`` lowers to) and recomputes
the rest, K5 and K7 included (they run inside ``autograd.Function``s, as
a Pallas call reruns under JAX's policy). ``"none"`` runs plain.
``remat_group > 1`` that divides the layers adds JAX's two-level remat:
each group of that many decoder layers, with their cross K/V, runs in
one outer checkpoint, every layer inside it wrapped as ``remat`` says; a
group that does not divide the layers falls back to the flat loop, as in
JAX. Every family trains: the SSD scan's gradient is
``kernels/ssd_scan.ssd_scan_bwd``. ``kv_repeat`` repeats each K/V head
(``attention._repeat_kv``) before K5 and in the cache, whose head axis
holds ``num_kv_heads * kv_repeat`` heads.

The decode cache holds the JAX names, stacked on a leading layers axis:
``k``/``v`` [L, B, S_cache, Hs, dh] (Hs = Hkv * kv_repeat; int8 with
``k_scale``/``v_scale`` [L, B, S_cache, Hs] when ``kv_cache_bits=8``),
``ssm`` [L, B, H, P, N] float32 and ``conv_x``/``conv_b``/``conv_c``,
``cross_k``/``cross_v`` [L, B, F, Hs, dh] in the compute type (16-bit
under ``kv_cache_bits=8`` too), with ``pos`` a 0-dim int32 tensor; the
VLM's positions count the patches, so after a prefill of F patches and S
tokens ``pos`` is F + S. ``decode_step`` writes the new token's entries into the cache in
place and returns it with ``pos + 1`` (the JAX function returns a new
cache); clone a cache to keep it. ``cache_specs`` gives every leaf's
logical axes, the JAX ``cache_specs`` with its stacked ``layers`` axis.

Under a mesh of more than one rank (the ambient ``ShardCtx`` of
``distributed/sharding.py``, JAX's ``launch/dryrun.py`` construction of
the train step), every family trains sharded: ``init`` keeps this
rank's shard of each parameter, cut as each layer is drawn (``specs()``
gives every
parameter's logical axes, the JAX ``specs()`` under ``convert.py``'s
naming, without the stacked layers axis); ``_split`` gathers the FSDP
dims over ``data`` (the gradient is reduce-scattered back); the layers
move their activations over ``model`` themselves (``models/layers.py``,
``attention.py``, ``moe.py``, ``ssm.py``; each branch of the hybrid
reduces its own output, so a layout that splits one branch and keeps the
other whole needs nothing more); and ``loss`` is a vocab-parallel
cross-entropy (the max, the sum of exponentials and the gold logit
reduced over ``model``) whose CE sum is divided by the *global* token
count (reduced over the batch axes), so that the gradients summed over
the data shards are those of JAX's global mean. They serve sharded too:
``init_cache`` takes the *global* batch and allocates this rank's piece of
each leaf by ``cache_specs`` under the ambient rules (``pos``
replicated); ``prefill`` takes this data shard's rows and fills this
rank's piece, its logits this rank's vocab shard: under the prefill
rules of ``sharding_profile`` its stored KV heads (``KV_HEADS ->
model``), under the decode rules every KV head over its slice of the
sequence (``KV_SEQ -> model`` where the profile shards it).
``decode_step`` runs under the decode rules context-parallel
(``attention.py``), each rank writing the token only where its slice
holds the slot, and under the prefill rules head-parallel, each rank
writing it into its stored heads. As JAX's dry-run pairs them, serving
prefills under the prefill rules and decodes under the decode rules: a
prefill cache reaches the decode layout by a gather and a re-placement
(``convert.gather_cache``, ``convert.shard_cache``). Without autograd,
a weight's FSDP gather is kept and reused while its shard is unchanged,
so a decode step moves the step's activations and not the weights. The
SSM state and conv tails are split by ``SSD_HEADS`` under every rule set,
so they keep their layout from prefill to decode, and
``prefill_streaming`` (SSM-only) runs under the prefill rules as
``prefill`` does. The encoder runs its block on this data shard's
frames, head- and MLP-parallel as a decoder layer is; ``_cross_kv``
projects each decoder layer's cross K/V of this rank's stored heads,
the encoder output entering them through ``copy_to``. The prefill's
``cross_k``/``cross_v`` hold this rank's heads (``KV_HEADS -> model``),
the decode layout every stored head, against which each rank's q heads
attend their own (``attention._cross_decode``). The VLM's patch prefix
is this shard's rows, and its text-tail loss is the vocab-parallel one.

A window arch keeps the last ``window`` keys of a longer prompt in slots
``0..window-1`` and decodes position ``pos`` into slot ``pos % window``,
as the JAX package does: the ring is aligned only when the prompt length
is a multiple of the window (ROADMAP Queue 3).
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch._device import resolve_device
from repro_torch.configs.base import (
    FAMILY_AUDIO, FAMILY_DENSE, FAMILY_ENCDEC, FAMILY_HYBRID, FAMILY_MOE,
    FAMILY_SSM, FAMILY_VLM, ModelConfig,
)
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as lyr
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.obs import lm

REMAT = ("none", "full", "dots")
#: the operations whose outputs ``remat="dots"`` saves
DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
        torch.ops.aten.baddbmm)
FAMILIES = (FAMILY_DENSE, FAMILY_MOE, FAMILY_SSM, FAMILY_HYBRID,
            FAMILY_VLM, FAMILY_AUDIO, FAMILY_ENCDEC)
#: the families whose decoder layers cross-attend an encoder
CROSS = (FAMILY_ENCDEC, FAMILY_AUDIO)
#: the batch key of each frontend family's stub embeddings [B, F, D]:
#: the encoder's frames, the VLM's patches
STUB_INPUTS = {FAMILY_AUDIO: "frame_embeds", FAMILY_ENCDEC: "frame_embeds",
               FAMILY_VLM: "patch_embeds"}
#: the heads of the parameter tree, in the JAX tree's order, and those
#: stacked over the layers there (``layers.<i>.`` and ``encoder.<i>.`` here)
HEADS = ("embed", "layers", "encoder", "enc_norm", "final_norm")
STACKED = ("layers", "encoder")


def _layer_init(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, device, cross: bool = False) -> dict:
    """One layer's parameters for cfg.family; ``cross`` adds the
    cross-attention block (``ln_x``, ``xattn``) of an enc-dec decoder
    layer."""
    params = {"ln1": lyr.rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.family != FAMILY_SSM:
        params["attn"] = attn_mod.attn_init(generator, cfg, dtype, device)
    if cfg.family in (FAMILY_SSM, FAMILY_HYBRID):
        params["ssd"] = ssm_mod.ssd_init(generator, cfg, dtype, device)
    if cross:
        params["ln_x"] = lyr.rmsnorm_init(cfg.d_model, dtype, device)
        params["xattn"] = attn_mod.attn_init(generator, cfg, dtype, device)
    if cfg.family == FAMILY_MOE:
        params["ln2"] = lyr.rmsnorm_init(cfg.d_model, dtype, device)
        params["moe"] = moe_mod.moe_init(generator, cfg, dtype, device)
    elif cfg.d_ff > 0:
        params["ln2"] = lyr.rmsnorm_init(cfg.d_model, dtype, device)
        params["mlp"] = lyr.mlp_init(generator, cfg, dtype, device)
    return params


def _layer_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """Logical axes of ``_layer_init``'s parameters."""
    specs = {"ln1": lyr.NORM_SPECS}
    if cfg.family != FAMILY_SSM:
        specs["attn"] = attn_mod.attn_specs(cfg)
    if cfg.family in (FAMILY_SSM, FAMILY_HYBRID):
        specs["ssd"] = ssm_mod.ssd_specs(cfg)
    if cross:
        specs["ln_x"] = lyr.NORM_SPECS
        specs["xattn"] = attn_mod.attn_specs(cfg)
    if cfg.family == FAMILY_MOE:
        specs["ln2"] = lyr.NORM_SPECS
        specs["moe"] = moe_mod.moe_specs(cfg)
    elif cfg.d_ff > 0:
        specs["ln2"] = lyr.NORM_SPECS
        specs["mlp"] = lyr.mlp_specs(cfg)
    return specs


def _flat_specs(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _layer_forward(lp, x: torch.Tensor, *, cfg: ModelConfig,
                   positions: torch.Tensor, window: int,
                   causal: bool = True, kv_repeat: int = 1,
                   cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                   = None, xattn_len=None, kv_valid_len=None,
                   collect_kv: bool = False, collect_state: bool = False,
                   layer: int = -1
                   ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One layer over the full sequence: attention and/or the SSD block on
    the RMS-normed input (their mean for the hybrid), added to the
    residual; where ``cross_kv`` is given, cross-attention from the
    ``ln_x``-normed x to those K/V (q at ``positions``, non-causal), added
    to the residual; then the MoE FFN or the MLP. ``kv_valid_len`` [B]
    masks self-attention's keys past each row's length, ``xattn_len`` [B]
    cross-attention's frames (its ``kv_valid_len``), as the JAX layer
    takes them. Returns (x, aux, collected): the MoE aux loss (a float32 0
    for the other families), and the post-RoPE K/V and the SSM state and
    conv tail, as asked. ``layer`` is the index its spans carry:
    ``model.attn``, ``model.ssd``, ``model.xattn`` and the FFN's
    ``model.mlp`` (the MLP or the MoE FFN), each from its norm to its
    residual add; in the hybrid, ``model.attn`` from the shared norm
    through attention, then ``model.ssd`` from the SSD heads through the
    mean and the add."""
    cd = x.dtype
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    collected: dict = {}
    delta = None
    if "attn" in lp:
        with lm.span("model.attn", layer=layer):
            h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
            delta, kv = attn_mod.attn_forward(
                lp["attn"], h, cfg, positions=positions,
                kv_repeat=kv_repeat, causal=causal, window=window,
                return_kv=collect_kv, kv_valid_len=kv_valid_len)
            if collect_kv:
                collected["k"], collected["v"] = kv
            if "ssd" not in lp:
                x = x + delta
    if "ssd" in lp:
        with lm.span("model.ssd", layer=layer):
            if delta is None:
                h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
            s_out, state = ssm_mod.ssd_forward(lp["ssd"], h, cfg,
                                               return_state=collect_state)
            if collect_state:
                collected["ssm"] = state["ssm"]
                collected["conv_x"] = state["conv"]["x"]
                collected["conv_b"] = state["conv"]["B"]
                collected["conv_c"] = state["conv"]["C"]
            if delta is None:
                x = x + s_out
            else:                           # hymba: mean of parallel heads
                x = x + (delta + s_out) * 0.5
    if cross_kv is not None:
        with lm.span("model.xattn", layer=layer):
            hx = lyr.rmsnorm_apply(lp["ln_x"], x, cfg.norm_eps, cd)
            x = x + attn_mod.attn_forward(
                lp["xattn"], hx, cfg, positions=positions, causal=False,
                xattn_kv=cross_kv, kv_valid_len=xattn_len)[0]
    if "moe" in lp:
        with lm.span("model.mlp", layer=layer):
            h2 = lyr.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps, cd)
            m_out, m_aux = moe_mod.moe_forward(lp["moe"], h2, cfg)
            x = x + m_out
            aux = aux + m_aux
    elif "mlp" in lp:
        with lm.span("model.mlp", layer=layer):
            h2 = lyr.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps, cd)
            x = x + lyr.mlp_apply(lp["mlp"], h2, cfg, cd)
    x = shd.constrain(x, shd.BATCH, None, None)
    return x, aux, collected


def _layer_train(lp, x, cross_kv=None, **kw
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, aux) of one layer: what the checkpointed layer returns."""
    return _layer_forward(lp, x, cross_kv=cross_kv, **kw)[:2]


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``'s policy: keep what a matrix product returns,
    recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _in_ctx(fn):
    """``fn`` under the ambient ``ShardCtx`` of this call: a checkpoint's
    recompute runs in the backward, on autograd's device thread on the
    card, where the thread-local context is not set."""
    ctx = shd.current_ctx()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with shd.use_ctx(ctx):
            return fn(*args, **kwargs)
    return run


def _remat_wrap(fn, policy: str):
    """``fn`` under ``policy``: plain, checkpointed, or checkpointed
    saving the matrix products. While the LM tracer is on, the spans of
    a recompute carry ``recompute=True``."""
    if policy == "none":
        return fn
    fn = _in_ctx(fn)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    if lm.TRACER.enabled:
        kw["context_fn"] = lm.recompute_marked(
            kw.get("context_fn", noop_context_fn))
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _layer_decode(lp, x: torch.Tensor, cfg: ModelConfig, *,
                  cache_layer: dict, cache_pos: int, window: int,
                  kv_repeat: int = 1, xattn_len=None,
                  dus_write: bool = False, layer: int = -1) -> torch.Tensor:
    """Single-token layer step. ``cache_layer`` holds this layer's views
    of the stacked cache, which are updated in place (the cross K/V are
    only read, under ``xattn_len``'s mask of each row's valid frames).
    Its spans are ``_layer_forward``'s."""
    cd = x.dtype
    delta = None
    if "attn" in lp:
        with lm.span("model.attn", layer=layer):
            h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
            scales = None
            if "k_scale" in cache_layer:
                scales = (cache_layer["k_scale"], cache_layer["v_scale"])
            delta, _, _, _ = attn_mod.attn_decode(
                lp["attn"], h, cfg, cache_k=cache_layer["k"],
                cache_v=cache_layer["v"], cache_pos=cache_pos,
                kv_repeat=kv_repeat, window=window, kv_scales=scales,
                dus_write=dus_write)
            if "ssd" not in lp:
                x = x + delta
    if "ssd" in lp:
        with lm.span("model.ssd", layer=layer):
            if delta is None:
                h = lyr.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps, cd)
            state = {"ssm": cache_layer["ssm"],
                     "conv": {"x": cache_layer["conv_x"],
                              "B": cache_layer["conv_b"],
                              "C": cache_layer["conv_c"]}}
            s_out, new = ssm_mod.ssd_decode(lp["ssd"], h, cfg, state=state)
            cache_layer["ssm"].copy_(new["ssm"])
            cache_layer["conv_x"].copy_(new["conv"]["x"])
            cache_layer["conv_b"].copy_(new["conv"]["B"])
            cache_layer["conv_c"].copy_(new["conv"]["C"])
            if delta is None:
                x = x + s_out
            else:
                x = x + (delta + s_out) * 0.5
    if "xattn" in lp:
        with lm.span("model.xattn", layer=layer):
            hx = lyr.rmsnorm_apply(lp["ln_x"], x, cfg.norm_eps, cd)
            x = x + attn_mod.attn_decode(
                lp["xattn"], hx, cfg, cache_k=None, cache_v=None,
                cache_pos=cache_pos,
                xattn_kv=(cache_layer["cross_k"], cache_layer["cross_v"]),
                xattn_len=xattn_len)[0]
    if "moe" in lp:
        with lm.span("model.mlp", layer=layer):
            # capacity from the B tokens of this step: none is dropped
            h2 = lyr.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps, cd)
            x = x + moe_mod.moe_forward(lp["moe"], h2, cfg)[0]
    elif "mlp" in lp:
        with lm.span("model.mlp", layer=layer):
            h2 = lyr.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps, cd)
            x = x + lyr.mlp_apply(lp["mlp"], h2, cfg, cd)
    return x


def _shard_tree(tree: dict, prefix: str, specs: dict,
                ctx: shd.ShardCtx) -> dict:
    """``tree`` (parameters named under ``prefix``) with each tensor cut to
    this rank's shard by its logical axes in ``specs``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _shard_tree(v, f"{prefix}{k}.", specs, ctx)
        else:
            sl = shd.shard_slices(v.shape, ctx.pspec(*specs[prefix + k]),
                                  ctx.mesh)
            out[k] = v[sl].clone()
    return out


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
    """The model of one config, of any family, on one device or one rank
    of a mesh.

    ``causal_skip`` is accepted and has nothing to switch: K5 and K6
    always skip the tiles that the causal mask empties; nor has
    ``kv_dus_write``: the port's one per-shard write gives the results of
    both JAX writes."""

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
        if kv_cache_bits not in (8, 16):
            raise ValueError(f"kv_cache_bits must be 8 or 16, got "
                             f"{kv_cache_bits}")
        self.cfg = cfg
        self.kv_repeat = kv_repeat
        self.remat_group = remat_group
        self.causal_skip = causal_skip
        self.kv_cache_bits = kv_cache_bits
        self.kv_dus_write = kv_dus_write
        self.device = resolve_device(device)
        self.embed = nn.ParameterDict()
        self.layers = nn.ModuleList()
        self.encoder = nn.ModuleList()
        self.enc_norm = nn.ParameterDict()
        self.final_norm = nn.ParameterDict()
        #: name -> (the shard, (its version, storage, pspec), the weight
        #: gathered from it), kept by ``_gather_fsdp`` without autograd
        self._gathered: dict = {}

    # -------------------------------------------------- init
    def init(self, generator: torch.Generator) -> Dict[str, nn.Parameter]:
        """Draw the parameters from ``generator`` (on the model's device)
        into the model, and return them by name. The draws are not the JAX
        package's (``jax.random`` and torch differ): tests carry JAX
        weights across with ``convert.model_params_from_jax``."""
        cfg, dev = self.cfg, self.device
        dtype = lyr.dtype_of(cfg.param_dtype)
        cross = cfg.family in CROSS
        ctx = shd.mesh_ctx()
        specs = self.specs() if ctx is not None else None

        def keep(tree: dict, prefix: str) -> dict:
            # under a mesh each tensor is cut to this rank's shard as soon
            # as its subtree is drawn: a rank never holds more than one
            # layer (or the embeddings) whole, whatever the depth
            return tree if ctx is None else _shard_tree(tree, prefix,
                                                        specs, ctx)

        self.embed = _Params(keep(lyr.embed_init(generator, cfg, dtype, dev),
                                  "embed."))
        self.layers = nn.ModuleList(
            _Params(keep(_layer_init(generator, cfg, dtype, dev, cross=cross),
                         f"layers.{i}."))
            for i in range(cfg.num_layers))
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                _Params(keep(_layer_init(generator, cfg, dtype, dev),
                             f"encoder.{i}."))
                for i in range(cfg.encoder_layers))
            self.enc_norm = _Params(keep(lyr.rmsnorm_init(
                cfg.d_model, dtype, dev), "enc_norm."))
        self.final_norm = _Params(keep(lyr.rmsnorm_init(cfg.d_model, dtype,
                                                        dev), "final_norm."))
        return dict(self.named_parameters())

    def specs(self) -> Dict[str, tuple]:
        """Every parameter's logical axes by name (``init``'s keys): the
        JAX ``specs()`` under ``convert.py``'s naming, each stacked leaf's
        leading ``layers`` axis dropped, as the port keeps one tensor a
        layer."""
        cfg = self.cfg
        out = _flat_specs({"embed": lyr.embed_specs(cfg)}, "")
        layer = _flat_specs(_layer_specs(cfg, cross=cfg.family in CROSS), "")
        for i in range(cfg.num_layers):
            out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
        if cfg.encoder_layers:
            enc = _flat_specs(_layer_specs(cfg), "")
            for i in range(cfg.encoder_layers):
                out.update({f"encoder.{i}.{k}": v for k, v in enc.items()})
            out["enc_norm.scale"] = lyr.NORM_SPECS["scale"]
        out["final_norm.scale"] = lyr.NORM_SPECS["scale"]
        return out

    def _gather_fsdp(self, params: Mapping[str, torch.Tensor],
                     ctx: shd.ShardCtx) -> Dict[str, torch.Tensor]:
        """Each local shard with its dims over the data-parallel axes
        gathered (ZeRO-3's use of a weight); the model-axis dims stay
        local. Without autograd (serving) a gathered weight is kept, and
        reused while the same shard, unchanged in place, comes under the
        same pspec."""
        specs = self.specs()
        keep = not torch.is_grad_enabled()
        out = {}
        for name, shard in params.items():
            pspec = ctx.pspec(*specs[name])
            key = (shard._version, shard.data_ptr(), pspec)
            hit = self._gathered.get(name) if keep else None
            if hit is not None and hit[0] is shard and hit[1] == key:
                out[name] = hit[2]
                continue
            t = shard
            for dim, entry in enumerate(pspec):
                axes = [a for a in shd.entry_axes(entry)
                        if a != shd.MODEL_AXIS]
                if axes:
                    t = col.gather(t, ctx.mesh, axes, dim)
            if keep:
                self._gathered[name] = (shard, key, t)
            out[name] = t
        return out

    def _split(self, params: Optional[Mapping[str, torch.Tensor]]) -> dict:
        """``params`` (``None``: the model's own) by head of the tree:
        ``embed``, ``enc_norm`` and ``final_norm`` as nested trees,
        ``layers`` and ``encoder`` as one nested tree per layer. A name
        under no head raises: it would otherwise get no gradient and no
        update."""
        p = dict(self.named_parameters()) if params is None else params
        ctx = shd.mesh_ctx()
        if ctx is not None:
            p = self._gather_fsdp(p, ctx)
        cfg = self.cfg
        flat: dict = {"embed": {}, "enc_norm": {}, "final_norm": {},
                      "layers": [{} for _ in range(cfg.num_layers)],
                      "encoder": [{} for _ in range(cfg.encoder_layers)]}
        for name, t in p.items():
            head, _, rest = name.partition(".")
            if head not in HEADS:
                raise KeyError(f"parameter {name!r} is under no head of "
                               f"the model's tree ({HEADS})")
            if head in STACKED:
                i, _, leaf = rest.partition(".")
                flat[head][int(i)][leaf] = t
            else:
                flat[head][rest] = t
        return {k: [lyr.nest(lp) for lp in v] if isinstance(v, list)
                else lyr.nest(v) for k, v in flat.items()}

    def _head(self, embed: dict, final: dict, x: torch.Tensor,
              cd: torch.dtype) -> torch.Tensor:
        with lm.span("model.head"):
            return self._unembed(embed, final, x, cd)

    def _unembed(self, embed: dict, final: dict, x: torch.Tensor,
                 cd: torch.dtype) -> torch.Tensor:
        """The final norm, then the fp32 logits."""
        x = lyr.rmsnorm_apply(final, x, self.cfg.norm_eps, cd)
        return lyr.unembed_apply(embed, x, self.cfg)

    # -------------------------------------------------- embedding helpers
    def _embed_inputs(self, embed: dict, batch) -> tuple:
        """(embeds [B, S, D], positions [B, S]): the tokens' embeddings,
        behind the VLM's patch embeddings where the batch has them."""
        cd = lyr.dtype_of(self.cfg.compute_dtype)
        with lm.span("model.embed"):
            emb = lyr.embed_apply(embed, batch["tokens"], cd)
        if self.cfg.family == FAMILY_VLM and "patch_embeds" in batch:
            emb = torch.cat([batch["patch_embeds"].to(cd), emb], dim=1)
        b, s = emb.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=emb.device).expand(b, s)
        return emb, positions

    def _encode(self, tree: dict, batch) -> torch.Tensor:
        """The encoder stack over ``batch["frame_embeds"]`` [B, F, D]:
        bidirectional, unwindowed, each layer under ``remat``; then
        ``enc_norm``."""
        cfg = self.cfg
        cd = lyr.dtype_of(cfg.compute_dtype)
        x = batch["frame_embeds"].to(cd)
        b, f = x.shape[:2]
        positions = torch.arange(f, dtype=torch.int32,
                                 device=x.device).expand(b, f)
        fn = _remat_wrap(functools.partial(
            _layer_train, cfg=cfg, positions=positions, window=0,
            causal=False, kv_repeat=self.kv_repeat), cfg.remat)
        with lm.span("model.encoder"):
            for i, lp in enumerate(tree["encoder"]):
                x, _ = fn(lp, x, layer=i)
            return lyr.rmsnorm_apply(tree["enc_norm"], x, cfg.norm_eps, cd)

    def _cross_kv(self, tree: dict, enc_out: torch.Tensor) -> list:
        """Every decoder layer's cross (k, v) [B, F, Hs, dh] from the
        encoder output: K RoPE'd at the encoder's positions, both
        repeated by ``kv_repeat``; under a mesh this rank's stored heads
        (``attention.kv_heads``: the encoder output behind ``copy_to``, or
        the heads where the parameter heads do not shard, so that the
        encoder's gradient sums every rank's heads)."""
        b, f = enc_out.shape[:2]
        positions = torch.arange(f, dtype=torch.int32,
                                 device=enc_out.device).expand(b, f)
        return [attn_mod.kv_heads(lp["xattn"], enc_out, self.cfg,
                                  positions=positions,
                                  kv_repeat=self.kv_repeat)
                for lp in tree["layers"]]

    def _decoder_inputs(self, tree: dict, batch) -> tuple:
        """(embeds, positions, each decoder layer's cross K/V or None)."""
        emb, positions = self._embed_inputs(tree["embed"], batch)
        cross = [None] * self.cfg.num_layers
        if self.cfg.encoder_layers:
            cross = self._cross_kv(tree, self._encode(tree, batch))
        return emb, positions, cross

    # -------------------------------------------------- train forward
    def train_logits(self, params: Optional[Mapping[str, torch.Tensor]],
                     batch) -> tuple:
        """Teacher-forced forward. Returns (logits fp32 [B,S,Vp], aux);
        the VLM's S counts the patches."""
        x, aux, tree, cd = self._trunk(params, batch)
        return self._head(tree["embed"], tree["final_norm"], x, cd), aux

    def _trunk(self, params, batch) -> tuple:
        """The forward up to the head: (x, aux, the parameter tree, the
        compute type)."""
        cfg = self.cfg
        tree = self._split(params)
        cd = lyr.dtype_of(cfg.compute_dtype)
        x, positions, cross = self._decoder_inputs(tree, batch)
        fn = _remat_wrap(functools.partial(
            _layer_train, cfg=cfg, positions=positions,
            window=cfg.attn_window, kv_repeat=self.kv_repeat), cfg.remat)

        def run(lps, ckvs, x, aux, first=0):
            for i, (lp, ckv) in enumerate(zip(lps, ckvs), first):
                x, a = fn(lp, x, ckv, layer=i)
                aux = aux + a
            return x, aux

        layers = tree["layers"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        g = self.remat_group
        if g > 1 and cfg.num_layers % g == 0:
            kw = {"context_fn": lm.recompute_marked(noop_context_fn)} \
                if lm.TRACER.enabled else {}
            for i in range(0, cfg.num_layers, g):
                x, aux = checkpoint(_in_ctx(run), layers[i:i + g],
                                    cross[i:i + g], x,
                                    aux, i, use_reentrant=False, **kw)
        else:
            x, aux = run(layers, cross, x, aux)
        return x, aux, tree, cd

    def loss(self, params: Optional[Mapping[str, torch.Tensor]],
             batch) -> tuple:
        """Mean CE over targets >= 0 (+ the MoE aux); the VLM's logits
        are scored on the text tail only. Returns (loss, metrics). The
        span ``model.head`` covers the final norm, the unembedding and
        the cross-entropy; under the device clock its backward is timed
        between two identity nodes (``lm.backward_stamp``)."""
        x, aux, tree, cd = self._trunk(params, batch)
        with lm.span("model.head") as head:
            x = lm.backward_stamp(head, x)
            logits = self._unembed(tree["embed"], tree["final_norm"], x, cd)
            loss, metrics = self._score(logits, aux, batch)
            return lm.backward_stamp(head, loss), metrics

    def _score(self, logits: torch.Tensor, aux: torch.Tensor,
               batch) -> tuple:
        """``loss``'s cross-entropy of the logits."""
        targets = batch["targets"].long()
        if logits.shape[1] != targets.shape[1]:
            logits = logits[:, logits.shape[1] - targets.shape[1]:]
        mask = (targets >= 0).float()
        tgt = targets.clamp(min=0)
        ctx = shd.mesh_ctx()
        if ctx is not None:
            return self._mesh_loss(ctx, logits, aux, tgt, mask)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
        ce = (logz - gold) * mask
        ntok = mask.sum().clamp(min=1.0)
        loss = ce.sum() / ntok + aux
        return loss, {"ce": ce.sum() / ntok, "aux": aux, "ntok": ntok}

    def _mesh_loss(self, ctx: shd.ShardCtx, logits: torch.Tensor,
                   aux: torch.Tensor, tgt: torch.Tensor,
                   mask: torch.Tensor) -> tuple:
        """The loss on a data shard with this rank's vocab shard of the
        logits: the softmax's max, sum and the gold logit reduced over
        ``model``; this shard's CE sum over the *global* token count.
        Returns (the loss this rank differentiates, the global metrics,
        ``loss`` among them). Where the batch is replicated over a
        data-parallel axis, each replica takes its share of the loss."""
        mesh, axis = ctx.mesh, ctx.axis(shd.VOCAB)
        batch_axes = ctx.profile.batch_axes
        m = col.all_reduce(logits.detach().amax(-1), mesh, axis, op="max")
        sumexp = col.reduce_from(torch.exp(logits - m[..., None]).sum(-1),
                                 mesh, axis)
        logz = torch.log(sumexp) + m
        vp = logits.shape[-1]
        local = tgt - (0 if axis is None else mesh.index(axis) * vp)
        hit = (local >= 0) & (local < vp)
        gold = torch.gather(logits, -1, local.clamp(0, vp - 1)[..., None])
        gold = col.reduce_from(gold[..., 0] * hit, mesh, axis)
        ce = ((logz - gold) * mask).sum()
        ntok = _global_ntok(mask.sum(), mesh, batch_axes).clamp(min=1.0)
        replicas = mesh.world // (ctx.shards(batch_axes)
                                  * mesh.size(shd.MODEL_AXIS))
        loss = (ce / ntok + aux) / replicas
        ce_all = col.all_reduce(ce.detach(), mesh, batch_axes) / ntok
        aux = aux.detach()
        return loss, {"ce": ce_all, "aux": aux, "ntok": ntok,
                      "loss": ce_all + aux}

    # -------------------------------------------------- serving
    def cache_len_for(self, seq_len: int) -> int:
        if self.cfg.attn_window:
            return min(seq_len, self.cfg.attn_window)
        return seq_len

    def cache_specs(self) -> dict:
        """Logical axes of every leaf of ``init_cache``'s cache, as the JAX
        ``cache_specs`` gives them (the leading ``layers`` axis kept: the
        port's cache stacks the layers too)."""
        cfg = self.cfg
        L, B = shd.LAYERS, shd.BATCH
        layers: Dict[str, tuple] = {}
        if cfg.has_attention:
            for name in ("k", "v"):
                layers[name] = (L, B, shd.KV_SEQ, shd.KV_HEADS, None)
            if self.kv_cache_bits == 8:
                for name in ("k_scale", "v_scale"):
                    layers[name] = (L, B, shd.KV_SEQ, shd.KV_HEADS)
        if cfg.ssm.enabled:
            layers["ssm"] = (L, B, shd.SSD_HEADS, None, None)
            layers["conv_x"] = (L, B, None, shd.SSD_HEADS, None)
            layers["conv_b"] = (L, B, None, None)
            layers["conv_c"] = (L, B, None, None)
        if cfg.encoder_layers:
            for name in ("cross_k", "cross_v"):
                layers[name] = (L, B, None, shd.KV_HEADS, None)
        return {"pos": (), "layers": layers}

    def cache_shapes(self, batch_size: int, cache_len: int) -> dict:
        """Each leaf of the cache's full (global) shape and type."""
        cfg = self.cfg
        cd = lyr.dtype_of(cfg.compute_dtype)
        L, b = cfg.num_layers, batch_size
        hs, dh = cfg.num_kv_heads * self.kv_repeat, cfg.resolved_head_dim
        layers: Dict[str, tuple] = {}
        if cfg.has_attention:
            s_c = self.cache_len_for(cache_len)
            kv_dtype = torch.int8 if self.kv_cache_bits == 8 else cd
            for name in ("k", "v"):
                layers[name] = ((L, b, s_c, hs, dh), kv_dtype)
            if self.kv_cache_bits == 8:
                for name in ("k_scale", "v_scale"):
                    layers[name] = ((L, b, s_c, hs), cd)
        if cfg.ssm.enabled:
            _, nh, p, n = ssm_mod.ssm_dims(cfg)
            cw = cfg.ssm.conv_width
            layers["ssm"] = ((L, b, nh, p, n), torch.float32)
            layers["conv_x"] = ((L, b, cw - 1, nh, p), cd)
            for name in ("conv_b", "conv_c"):
                layers[name] = ((L, b, cw - 1, n), cd)
        if cfg.encoder_layers:
            for name in ("cross_k", "cross_v"):
                layers[name] = ((L, b, cfg.frontend_tokens, hs, dh), cd)
        return layers

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """Zeroed decode cache on the model's device. Under a mesh,
        ``batch_size`` is the global batch and each leaf is this rank's
        piece of it by ``cache_specs`` under the ambient rules."""
        dev = self.device
        ctx = shd.mesh_ctx()
        specs = self.cache_specs()["layers"]
        layers: Dict[str, torch.Tensor] = {}
        for name, (shape, dtype) in self.cache_shapes(batch_size,
                                                      cache_len).items():
            if ctx is not None:
                shape = shd.local_shape(shape, ctx.pspec(*specs[name]),
                                        ctx.mesh)
            layers[name] = torch.zeros(shape, dtype=dtype, device=dev)
        return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
                "layers": layers}

    @torch.no_grad()
    def prefill(self, params: Optional[Mapping[str, torch.Tensor]], batch,
                max_len: Optional[int] = None):
        """Process a prompt, return (last-token logits [B,1,Vp] fp32,
        filled cache).

        ``max_len``: cache capacity to allocate (>= the prompt's embedding
        length, the VLM's patches included) so subsequent ``decode_step``
        calls have room; defaults to that length + 1. A window arch keeps
        the last ``window`` keys of a longer prompt in slots
        ``0..window-1``. The cross K/V of every frame of the batch fill
        ``cross_k``/``cross_v``.

        Under a mesh: ``batch`` is this data shard's rows, the cache this
        rank's piece by ``cache_specs`` and the logits this rank's vocab
        shard. Under the prefill rules the piece is this rank's stored KV
        heads, every slot; under the decode rules (a prefill straight into
        the decode layout) every stored head over this rank's ``KV_SEQ``
        slice of the slots (all of them where the profile does not shard
        the sequence): each rank's q heads attend the stored heads they map
        to, and the cross K/V are every stored head."""
        cfg = self.cfg
        ctx = shd.mesh_ctx()
        cd = lyr.dtype_of(cfg.compute_dtype)
        tree = self._split(params)
        x, positions, cross = self._decoder_inputs(tree, batch)
        b, s = x.shape[:2]
        cap = max_len if max_len is not None else s + 1
        if cap < s and not cfg.attn_window:
            raise ValueError(f"prefill cache capacity {cap} < prompt "
                             f"embedding length {s}")
        if ctx is not None:
            b *= ctx.shards(ctx.rules.get(shd.BATCH))
        with lm.span("model.cache"):
            cache = self.init_cache(b, cap)
        cl = cache["layers"]
        for i, (lp, ckv) in enumerate(zip(tree["layers"], cross)):
            x, _, coll = _layer_forward(
                lp, x, cfg=cfg, positions=positions, window=cfg.attn_window,
                kv_repeat=self.kv_repeat, cross_kv=ckv,
                collect_kv=cfg.has_attention, collect_state=cfg.ssm.enabled,
                layer=i)
            with lm.span("model.cache", layer=i):
                if cfg.has_attention:
                    self._fill_kv(cl, i, coll["k"], coll["v"], s)
                if cfg.ssm.enabled:
                    cl["ssm"][i] = coll["ssm"]
                    for name in ("conv_x", "conv_b", "conv_c"):
                        cl[name][i] = coll[name].to(cd)
        if cfg.encoder_layers:
            # as the JAX prefill, the cache holds the frames the batch has
            for j, name in enumerate(("cross_k", "cross_v")):
                cl[name] = torch.stack([ckv[j] for ckv in cross]).to(cd)
        logits = self._head(tree["embed"], tree["final_norm"], x[:, -1:], cd)
        cache["pos"].fill_(s)
        return logits, cache

    def _fill_kv(self, cl: dict, i: int, k: torch.Tensor, v: torch.Tensor,
                 s: int) -> None:
        """Layer ``i``'s prompt K/V [B, S, Hs, dh] into the cache: all of
        them, or the last S_cache of a window arch's longer prompt; where
        ``KV_SEQ`` splits the slots, this rank's slice of them."""
        s_loc = cl["k"].shape[2]
        ctx = shd.mesh_ctx()
        sa = ctx.axis(shd.KV_SEQ) if ctx is not None else None
        s_c = s_loc * (ctx.mesh.size(sa) if sa else 1)
        first = ctx.mesh.index(sa) * s_loc if sa else 0
        # global slots [0, n) hold prompt positions lo..: this slice's part
        lo = s - s_c if s_c < s else 0
        n = max(min(min(s, s_c) - first, s_loc), 0)
        src = slice(lo + first, lo + first + n)
        for name, t in (("k", k), ("v", v)):
            if self.kv_cache_bits == 8:
                t, scale = attn_mod._quantize_kv(t)
                cl[f"{name}_scale"][i, :, :n] = scale[:, src].to(
                    cl[f"{name}_scale"].dtype)
            cl[name][i, :, :n] = t[:, src].to(cl[name].dtype)

    @torch.no_grad()
    def prefill_streaming(self, params: Optional[Mapping[str, torch.Tensor]],
                          batch, chunk: int = 4096):
        """SSM-family chunked prefill: process an arbitrarily long prompt
        in fixed-size chunks carrying the SSM state (through K7's
        ``init_state``) and the conv tail between them, so that peak
        activation memory is O(chunk). Returns (last-token logits,
        decode-ready cache). Under a mesh (the prefill rules), as
        ``prefill``: this data shard's rows, this rank's cache and vocab
        shard of the logits."""
        cfg = self.cfg
        if cfg.family != FAMILY_SSM:
            raise ValueError("streaming prefill is SSM-only")
        cd = lyr.dtype_of(cfg.compute_dtype)
        tree = self._split(params)
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s % chunk and s >= chunk:
            raise ValueError("prompt length must be a multiple of the chunk")
        chunk = min(chunk, s)
        ctx = shd.mesh_ctx()
        if ctx is not None:
            b *= ctx.shards(ctx.rules.get(shd.BATCH))
        cache = self.init_cache(b, 1)
        cl = cache["layers"]
        x = None
        for c0 in range(0, s, chunk):
            x = lyr.embed_apply(tree["embed"], tokens[:, c0:c0 + chunk], cd)
            for i, lp in enumerate(tree["layers"]):
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
        logits = self._head(tree["embed"], tree["final_norm"], x[:, -1:], cd)
        cache["pos"].fill_(s)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params: Optional[Mapping[str, torch.Tensor]],
                    tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] -> (logits [B,1,Vp] fp32, the cache with this
        token written in place and ``pos + 1``). Under a mesh (the decode
        rules): this data shard's tokens, this rank's cache and vocab
        shard of the logits."""
        cfg = self.cfg
        cd = lyr.dtype_of(cfg.compute_dtype)
        tree = self._split(params)
        with lm.span("model.embed"):
            x = lyr.embed_apply(tree["embed"], tokens, cd)
        with lm.span("decode.pos_read"):
            pos = lm.host_read(cache["pos"])
        cl = cache["layers"]
        for i, lp in enumerate(tree["layers"]):
            x = _layer_decode(lp, x, cfg,
                              cache_layer={k: t[i] for k, t in cl.items()},
                              cache_pos=pos, window=cfg.attn_window,
                              kv_repeat=self.kv_repeat,
                              dus_write=self.kv_dus_write, layer=i)
        logits = self._head(tree["embed"], tree["final_norm"], x, cd)
        cache["pos"] = torch.full((), pos + 1, dtype=torch.int32,
                                  device=cache["pos"].device)
        return logits, cache


def _global_ntok(ntok: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """The token count of the whole batch: this shard's, summed over the
    batch axes."""
    return col.all_reduce(ntok.detach(), mesh, batch_axes)

