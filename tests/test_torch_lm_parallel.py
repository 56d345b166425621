"""The LM half of multi-device training on the port: data-, tensor-,
FSDP- and expert-parallel train steps over a process group, for every
family, held to the JAX package's own sharded step and to the port's
one-process step.

One world of four gloo ranks on the CPU (``launch.mesh.spawn_world``: a
``FileStore`` under ``tmp_path``, one torch thread a rank, a deadline on
every collective and on the run) runs every mesh of the module in turn,
each mesh a ``Mesh`` over some of its ranks:

- (2, 2), the reduced starcoder2-7b (fp32, GELU MLP with biases; one KV
  head repeated x2 for ``model`` 2): TP, FSDP and DP;
- (1, 4), the same model (KV repeated x4);
- (2, 1) on ranks 0-1, DP and FSDP only, two micro-batches a step;
- (2, 2), the reduced qwen3-moe-30b with ``expert_tp``;
- (2, 2) and (1, 4), the reduced mamba2-780m: SSD heads over ``model``
  (8 and 4 a rank), vocab-TP with tied embeddings; (1, 4) trains with
  the int8 ``grad_transform`` of JAX's dry-run, and (2, 2)'s gradients go
  through ``compress_grads`` (int8 and top-k) beside the one-process
  transform of the gathered gradients;
- (2, 2) and (1, 4), a reduced hymba-1.5b with the published model's
  divisibility (5 heads, 6 SSD heads): attention DP-only beside a split
  SSD block and MLP on (2, 2), attention and SSD DP-only beside a split
  MLP on (1, 4); and the reduced hymba-1.5b as ``reduced`` gives it on
  (2, 2), both branches split (against the one-process step alone);
- (2, 2), the reduced seamless-m4t-medium (audio: two encoder and two
  decoder layers over 16 stub frames, 4 heads and 4 KV heads, 2 a rank);
  (1, 4), a GQA variant of it with 2 KV heads, so that every rank
  projects both cross K/V heads, repeats them x2 and takes its slice;
  the same model as the enc-dec family on (2, 2) (against the
  one-process step alone); (2, 2), the reduced internvl2-76b (the VLM:
  16 stub patches ahead of the text, the loss on the text tail, one KV
  head repeated x2); and (2, 2), a reduced qwen3-moe-30b with 5 experts,
  which do not divide ``model``: every rank runs every expert over the
  tokens gathered from both data shards;
- the elastic round trip: (2, 2)'s state after its two steps
  checkpointed, restored onto (1, 2) on ranks 0-1 through
  ``elastic_reshard``, and two more steps;
- the controls: on the dense (2, 2), the ``o`` projection without its
  ``model`` reduce, and the CE over the local token count; on the SSM
  (2, 2), the SSD ``o`` projection without its reduce, and the gated norm
  over each rank's heads alone; on the SSM (1, 4), the int8 scale of
  each shard; on the audio (2, 2), the cross K/V's ``copy_to`` dropped
  (the encoder's gradient then holds only each rank's heads' share);
- under (1, 2), what the port once refused runs: ``kv_valid_len`` (a
  dense layer's output and input gradient against the one-process
  layer's), ``decode_step`` under the train rules and ``prefill`` into a
  sequence-sharded cache; every family builds;
- serving (``SERVE``) on (2, 2), (1, 4) and the MoE (2, 2): the sharded
  prefill under the prefill rules, then three decode steps under the
  decode rules (the context-parallel decode on a sequence-sharded
  cache), a replicated batch of 1, the 8-bit cache, a decode at
  ``pos == capacity`` and a capacity that does not divide ``model``;
  the SSM (2, 2) (its state split by SSD heads under both rules) and its
  ``prefill_streaming`` in two chunks, and the hybrid (2, 2) on its
  window ring; the audio (2, 2) (the cross cache handed over from the
  prefill's heads to every head) and the VLM (2, 2) (a capacity that
  counts the patches); their four controls (the fourth: the
  cross-attention's ``o`` reduce dropped in the audio decode), and the
  step factories end to end on the dense (2, 2) and the audio GQA
  (1, 4), whose prefill repeats the cross heads; and each layout under
  the other kind's rules ("swap": on the dense (2, 2) and (1, 4) and the
  audio (2, 2), a prefill under the decode rules straight into the
  sequence-sharded cache and three head-parallel decode steps under the
  prefill rules, the stored heads repeated x4 on (1, 4)).

Each mesh runs the first batch's logits, loss and gradients, then two
train steps from the JAX weights (``convert.shard_params_from_jax``), and
gathers what it got. Four subprocesses with four forced host devices
each run the JAX package's sharded step for three meshes apiece
(``JAX_GROUPS``), built as ``launch/dryrun.py:126-176`` builds it, and
execute it. The port's one-process step runs here, beside the world.

After its train step, each subprocess runs its share of JAX's serving
cells (``SERVE_GROUPS``, ``_JAX_SERVE``): the prefill and decode cells
built as ``launch/dryrun.py:179-204`` builds them and executed, the
decode with ``kv_dus`` False and True.

The logits, losses, gradients and serving caches are held at
``test_torch_models.py::test_model_matches_jax_float32``'s tolerances.
The updated parameters are held as ``test_torch_train.py`` holds an
AdamW update against JAX's: each parameter's update within 1% of its
norm. Element by element they are not comparable at the gradients'
tolerance: AdamW divides each gradient element by its own magnitude, so
an element near ``eps`` turns its rounding into the update. Attention's
key bias gets almost no gradient (the softmax ignores a shift common to
the keys, up to RoPE), and at two micro-batches JAX's and the port's
*one-process* steps already part by 9x the gradients' elementwise
tolerance on one element of an MLP bias.
"""
import dataclasses
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MeshConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import WorldError, make_mesh_from_config, \
    spawn_world
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainState, make_train_step

AXES = ("data", "model")
WORLD = 4
B, S, STEPS = 4, 32, 2
DENSE = dict(arch="starcoder2-7b", compute_dtype="float32",
             mlp_variant="gelu", use_bias=True)
MOE = dict(arch="qwen3-moe-30b-a3b", compute_dtype="float32")
#: the reduced mamba2-780m: 16 SSD heads, tied embeddings
SSM = dict(arch="mamba2-780m", compute_dtype="float32")
#: the reduced hymba-1.5b with the published model's divisibility: 5
#: heads (attention DP-only at ``model`` 2 and 4), 6 SSD heads (split at 2,
#: DP-only at 4), d_ff 512 (split at both)
HYB = dict(arch="hymba-1.5b", compute_dtype="float32", d_model=192,
           num_heads=5, ssm=dict(head_dim=64))
#: the reduced hymba-1.5b as ``reduced`` gives it: 4 heads (one KV head,
#: repeated x2 at ``model`` 2) and 16 SSD heads, both branches split
HYBTP = dict(arch="hymba-1.5b", compute_dtype="float32")
#: the reduced seamless-m4t-medium (audio), its GQA variant (2 KV heads:
#: repeated x2 at ``model`` 4) and the same model as the enc-dec family
AUD = dict(arch="seamless-m4t-medium", compute_dtype="float32")
AUDGQA = dict(AUD, num_kv_heads=2)
ENCDEC = dict(AUD, family="encdec")
#: the reduced internvl2-76b: 4 heads, one KV head (repeated x2 at
#: ``model`` 2), 16 stub patches
VLM = dict(arch="internvl2-76b", compute_dtype="float32")
#: a reduced qwen3-moe-30b whose 5 experts do not divide ``model``
MOE5 = dict(MOE, moe=dict(num_experts=5))
CONFIGS = {"dense": DENSE, "moe": MOE, "ssm": SSM, "hyb": HYB,
           "hybtp": HYBTP, "aud": AUD, "audgqa": AUDGQA, "encdec": ENCDEC,
           "vlm": VLM, "moe5": MOE5}
#: name -> (config, mesh shape, ranks, micro-batches)
MESHES = {
    "dense22": ("dense", (2, 2), (0, 1, 2, 3), 1),
    "dense14": ("dense", (1, 4), (0, 1, 2, 3), 1),
    "dense21": ("dense", (2, 1), (0, 1), 2),
    "moe22": ("moe", (2, 2), (0, 1, 2, 3), 1),
    "ssm22": ("ssm", (2, 2), (0, 1, 2, 3), 1),
    "ssm14": ("ssm", (1, 4), (0, 1, 2, 3), 1),
    "hyb22": ("hyb", (2, 2), (0, 1, 2, 3), 1),
    "hyb14": ("hyb", (1, 4), (0, 1, 2, 3), 1),
    "hybtp22": ("hybtp", (2, 2), (0, 1, 2, 3), 1),
    "aud22": ("aud", (2, 2), (0, 1, 2, 3), 1),
    "audgqa14": ("audgqa", (1, 4), (0, 1, 2, 3), 1),
    "encdec22": ("encdec", (2, 2), (0, 1, 2, 3), 1),
    "vlm22": ("vlm", (2, 2), (0, 1, 2, 3), 1),
    "moe522": ("moe5", (2, 2), (0, 1, 2, 3), 1),
}
#: the meshes that train with the int8 ``grad_transform`` as
#: ``launch/dryrun.py:163-169`` builds it (no error feedback)
INT8 = ("ssm14",)
#: the meshes held against the port's one-process step alone
WORLD_ONLY = ("hybtp22", "encdec22")
#: the meshes whose sharded gradients go through ``compress_grads`` (int8
#: and top-k, error feedback over two rounds) beside their one-process
#: transform
COMPRESS = ("ssm22",)
#: the meshes each JAX process runs the sharded step of, one process a key
JAX_GROUPS = {"dense22": ("dense22", "ssm22", "aud22"),
              "dense14": ("dense14", "ssm14", "audgqa14"),
              "dense21": ("dense21", "hyb22", "vlm22"),
              "moe22": ("moe22", "hyb14", "moe522")}
ELASTIC_MESH = (1, 2)
#: control -> the mesh whose first batch it runs with one piece dropped
CONTROLS = {"no_o_reduce": "dense22", "local_ntok": "dense22",
            "no_ssd_o_reduce": "ssm22", "local_norm": "ssm22",
            "int8_shard_scale": "ssm14", "no_cross_copy_to": "aud22"}
TIMEOUT_S = 240.0
#: serving: (mesh, case) -> the batch, the decode cache's capacity, its
#: bits, the decode steps, whether the case holds a prefill (the prompt is
#: S tokens) and whether the decode cache is sequence-sharded. "full"
#: decodes at pos == capacity, where the sequence-sharded JAX cache
#: writes nothing; "seq41"'s capacity does not divide ``model``, so the
#: decode cache is not sequence-sharded; their prefill is "base"'s. The
#: SSM's state and the hybrid's window ring are never sequence-sharded,
#: so JAX's two writes (``kv_dus``) are one program there and the case
#: runs one (``dus``); "stream" is the SSM's ``prefill_streaming`` in
#: ``chunks`` chunks, with no decode; the hybrid's prompt is a multiple
#: of its window. The audio case's prompt is S tokens over its frames;
#: the VLM's capacity counts its 16 patches (16 + S + 3 steps <= 56, a
#: multiple of ``model``). "swap" takes each step under the other kind's
#: rules: the prefill under the decode rules (``max_len`` the capacity,
#: straight into the sequence-sharded cache) and the decode steps under
#: the prefill rules (head-parallel, from a start cache whose stored heads
#: the prefill profile repeats)
SERVE = {
    ("dense22", "base"): dict(batch=B, cap=40, bits=16, steps=3),
    ("dense22", "int8"): dict(batch=B, cap=40, bits=8, steps=3),
    ("dense22", "b1"): dict(batch=1, cap=40, bits=16, steps=3),
    ("dense22", "full"): dict(batch=B, cap=S, bits=16, steps=1,
                              prefill=False),
    ("dense22", "seq41"): dict(batch=B, cap=41, bits=16, steps=3,
                               prefill=False, seq_shard=False),
    ("dense14", "base"): dict(batch=B, cap=40, bits=16, steps=3),
    ("moe22", "base"): dict(batch=B, cap=40, bits=16, steps=3),
    ("ssm22", "base"): dict(batch=B, cap=40, bits=16, steps=3,
                            seq_shard=False, dus=(0,)),
    ("ssm22", "stream"): dict(batch=B, cap=40, bits=16, steps=0, chunks=2,
                              seq_shard=False),
    ("hyb22", "base"): dict(batch=B, cap=40, bits=16, steps=3,
                            seq_shard=False, dus=(0,)),
    ("aud22", "base"): dict(batch=B, cap=40, bits=16, steps=3),
    ("vlm22", "base"): dict(batch=B, cap=56, bits=16, steps=3),
    ("dense22", "swap"): dict(batch=B, cap=40, bits=16, steps=3,
                              seq_shard=False, dus=(0,), swap=True),
    ("dense14", "swap"): dict(batch=B, cap=40, bits=16, steps=3,
                              seq_shard=False, dus=(0,), swap=True),
    ("aud22", "swap"): dict(batch=B, cap=40, bits=16, steps=3,
                            seq_shard=False, dus=(0,), swap=True),
}
#: the serving cells each JAX process runs after its meshes' train steps
SERVE_GROUPS = {"dense22": [("dense22", "b1"), ("dense22", "full"),
                            ("ssm22", "stream"), ("dense22", "int8")],
                "dense14": [("dense14", "base"), ("dense22", "seq41"),
                            ("ssm22", "base"), ("hyb22", "base")],
                "dense21": [("dense22", "base"), ("aud22", "base"),
                            ("dense22", "swap")],
                "moe22": [("moe22", "base"), ("vlm22", "base"),
                          ("dense14", "swap"), ("aud22", "swap")]}
#: the serving controls, each on a case's decode
SERVE_CONTROLS = {"no_merge_reduce": ("dense22", "base"),
                  "clamped_write": ("dense22", "base"),
                  "no_ssd_o_reduce": ("hyb22", "base"),
                  "no_cross_o_reduce": ("aud22", "base")}
#: the meshes whose greedy serving runs through the step factories end
#: to end (``_serve_e2e``), each at the dense "base" case's batch and
#: capacity, by the key of its result: the dense (2, 2), and the audio
#: GQA (1, 4), whose prefill repeats the cross heads x2 and whose
#: hand-over takes every second one
E2E = {"dense22": "serve_e2e", "audgqa14": "serve_e2e/audgqa14"}
#: the batch key of each frontend family's stub embeddings
STUBS = {"aud": "frame_embeds", "audgqa": "frame_embeds",
         "encdec": "frame_embeds", "vlm": "patch_embeds"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with(cfg, kw):
    """``cfg`` with the overrides ``kw`` (an ``ssm`` or ``moe`` dict
    overrides fields of ``cfg.ssm`` or ``cfg.moe``)."""
    kw = dict(kw)
    for sub in ("ssm", "moe"):
        if sub in kw:
            kw[sub] = dataclasses.replace(getattr(cfg, sub), **kw[sub])
    return dataclasses.replace(cfg, **kw)


def port_cfg(kind):
    kw = dict(CONFIGS[kind])
    return _with(reduced(get_config(kw.pop("arch"))), kw)


def _nest(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def jax_tree(inputs, kind):
    return _nest({k[len(kind) + 1:]: inputs[k] for k in inputs.files
                  if k.startswith(kind + "/")})


def batch_at(inputs, kind, i):
    out = {"tokens": torch.from_numpy(inputs[f"tokens_{kind}"][i]),
           "targets": torch.from_numpy(inputs[f"targets_{kind}"][i])}
    if kind in STUBS:
        out[STUBS[kind]] = torch.from_numpy(inputs[f"stub_{kind}"][i])
    return out


def prompt_batch(inputs, kind, rows):
    """(the serving prompt of ``rows`` rows: S tokens, behind the
    family's stub embeddings; the rows' S + 8 tokens)."""
    toks = torch.from_numpy(inputs[f"serve_tokens_{kind}"][:rows])
    out = {"tokens": toks[:, :S]}
    if kind in STUBS:
        out[STUBS[kind]] = torch.from_numpy(
            inputs[f"serve_stub_{kind}"][:rows])
    return out, toks


def prefix_len(kind):
    """The positions ahead of the text: the VLM's patches."""
    return port_cfg(kind).frontend_tokens if STUBS.get(kind) == \
        "patch_embeds" else 0


# ------------------------------------------------------------- the ranks
def _context(kind, shape, ranks):
    mesh_cfg = MeshConfig(shape, AXES)
    cfg = port_cfg(kind)
    mesh = make_mesh_from_config(mesh_cfg, "cpu", ranks=ranks)
    prof = shd.sharding_profile(cfg, mesh_cfg, B, S)
    ctx = shd.ShardCtx(mesh, shd.make_rules(cfg, mesh_cfg, B, S), prof)
    return cfg, mesh, ctx


def _gather(ctx, t, pspec):
    from repro_torch.train.elastic import Placement
    return Placement(ctx.mesh, pspec).gather(t.detach()).numpy()


def int8_transform(grads):
    """The int8 ``grad_transform`` of ``launch/dryrun.py:163-169``: each
    JAX leaf's round trip, no error feedback."""
    from repro_torch.train.compression import int8_leaves
    return int8_leaves(grads)


#: the compressors ``COMPRESS`` runs, two rounds each
COMPRESSORS = {"int8": dict(kind="int8"), "topk": dict(kind="topk",
                                                       topk_frac=0.05)}


def compress_rounds(grads, kind, ef=None):
    """Two rounds of ``compress_grads`` from a zero error feedback: what
    each sent, and the error feedback after them."""
    from repro_torch.train.compression import CompressorConfig, \
        compress_grads, init_error_feedback
    cfg = CompressorConfig(**COMPRESSORS[kind])
    ef = init_error_feedback(grads) if ef is None else ef
    sent1, ef = compress_grads(cfg, grads, ef)
    sent2, ef = compress_grads(cfg, grads, ef)
    return {"sent1": sent1, "sent2": sent2, "ef": ef}


def _first_batch(model, ctx, params, batch, moe_io=None, transform=None,
                 compress=False):
    """Logits, loss and reduced gradients of ``batch``, gathered; with
    ``transform``, what it makes of the gradients (tagged as the train
    step tags them); with ``compress``, ``compress_rounds`` of each
    compressor."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.train.compression import tag_shards
    from repro_torch.train.train_step import _axes_of, local_batch, \
        reduce_grads
    lb = local_batch(batch, ctx)
    plain = moe_mod.moe_forward

    def recording(p, x, cfg):
        y, aux = plain(p, x, cfg)
        moe_io.append((x.detach().numpy(), y.detach().numpy()))
        return y, aux

    if moe_io is not None:
        moe_mod.moe_forward = recording
    try:
        with torch.no_grad():
            logits, _ = model.train_logits(params, lb)
    finally:
        moe_mod.moe_forward = plain
    batch_spec = ctx.profile.batch_axes or None
    out = {"logits": _gather(ctx, logits, (batch_spec, None,
                                           ctx.rules[shd.VOCAB]))}
    loss, metrics = model.loss(params, lb)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    grads = reduce_grads(grads, model, ctx)
    specs = model.specs()

    def gathered(tree):
        return {n: _gather(ctx, g, ctx.pspec(*specs[n]))
                for n, g in tree.items()}

    out["loss0"] = float(metrics["loss"])
    out["grads"] = gathered(grads)
    tag_shards(grads, {n: _axes_of(ctx, specs[n]) for n in grads})
    if transform is not None:
        out["sent"] = gathered(transform(grads))
    if compress:
        out["compress"] = {kind: {k: gathered(t) for k, t in
                                  compress_rounds(grads, kind).items()}
                           for kind in COMPRESSORS}
    return out


def _train(model, ctx, state, inputs, kind, first, mu, transform=None):
    step = make_train_step(model, num_microbatches=mu,
                           grad_transform=transform)
    losses = []
    for i in range(first, first + STEPS):
        state, metrics = step(state, batch_at(inputs, kind, i))
        losses.append(float(metrics["loss"]))
    return state, losses


def _gathered_params(model, ctx, params):
    return {n: t.numpy() for n, t in convert.model_params_from_jax(
        convert.gather_params_to_jax(params, model, ctx)).items()}


def _run_mesh(name, inputs, rank, results):
    kind, shape, ranks, mu = MESHES[name]
    cfg, mesh, ctx = _context(kind, shape, ranks)
    if not mesh.member:
        return None
    transform = int8_transform if name in INT8 else None
    with shd.use_ctx(ctx):
        model = build_model(cfg, kv_repeat=ctx.profile.kv_repeat,
                            device="cpu")
        params = convert.shard_params_from_jax(jax_tree(inputs, kind), model)
        moe_io = [] if kind == "moe" else None
        out = _first_batch(model, ctx, params, batch_at(inputs, kind, 0),
                           moe_io, transform, compress=name in COMPRESS)
        out["profile"] = dict(attn_tp=ctx.profile.attn_tp,
                              ssd_tp=ctx.profile.ssd_tp,
                              mlp_tp=ctx.profile.mlp_tp,
                              kv_repeat=ctx.profile.kv_repeat)
        out["expert_tp"] = ctx.profile.expert_tp
        state = TrainState(params=params, opt=adamw_init(params))
        state, out["losses"] = _train(model, ctx, state, inputs, kind, 0, mu,
                                      transform)
        out["params"] = _gathered_params(model, ctx, state.params)
    results[name] = out if mesh.rank == 0 else None
    if moe_io is not None:
        results[f"{name}/moe_io/{mesh.rank}"] = dict(
            data=mesh.index("data"), io=moe_io)
    return model, ctx, state


def _elastic(inputs, first, ckpt_dir, rank, results):
    """(2, 2)'s state after two steps, checkpointed, restored onto (1, 2)
    on ranks 0-1 through ``elastic_reshard``; two more steps."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import elastic_reshard
    model, ctx, state = first
    with shd.use_ctx(ctx):
        path = ckpt.save_checkpoint(ckpt_dir, state, STEPS, model=model)
    cfg, mesh, ctx2 = _context("dense", ELASTIC_MESH, (0, 1))
    if not mesh.member:
        return
    full = build_model(cfg, kv_repeat=ctx2.profile.kv_repeat, device="cpu")
    like = TrainState(params={n: t.detach() for n, t in
                              full.init(torch.Generator().manual_seed(1))
                              .items()}, opt=None)
    like.opt = adamw_init(like.params)
    ckpt.restore_checkpoint(path, like)
    with shd.use_ctx(ctx2):
        model2 = build_model(cfg, kv_repeat=ctx2.profile.kv_repeat,
                             device="cpu")
        state2 = elastic_reshard(like, model2, mesh,
                                 MeshConfig(ELASTIC_MESH, AXES), B)
        state2, losses = _train(model2, ctx2, state2, inputs, "dense",
                                STEPS, 1)
        params = _gathered_params(model2, ctx2, state2.params)
        step = int(state2.opt["step"])
    if mesh.rank == 0:
        results["elastic"] = dict(losses=losses, params=params, step=step)


def _drop_reduce(p, x, cd, n, m, a):
    """``row_parallel`` without its ``model`` reduce."""
    from repro_torch.models import layers as lyr
    return lyr.row_parallel(p, x, cd, n, None, None)


def _without_copy_to(fn):
    """``fn`` with ``collectives.copy_to`` the identity while it runs."""
    from repro_torch.distributed import collectives as col

    def run(*args, **kwargs):
        real = col.copy_to
        col.copy_to = lambda x, mesh, axes: x
        try:
            return fn(*args, **kwargs)
        finally:
            col.copy_to = real
    return run


def _controls(inputs, rank, results):
    """A mesh's first batch with one piece dropped: the attention or SSD
    ``o`` projection's ``model`` reduce, the global token count, the gated
    norm's sum over ``model`` (each rank's heads normalised alone), the
    int8 scale's max over the shards, or the cross K/V's ``copy_to`` (the
    encoder output's, or the repeated heads')."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tr
    from repro_torch.train import compression
    for name, mesh_name in CONTROLS.items():
        kind, shape, ranks, _ = MESHES[mesh_name]
        cfg, mesh, ctx = _context(kind, shape, ranks)
        saved = (attn_mod.row_parallel, tr._global_ntok, ssm_mod.row_parallel,
                 ssm_mod._mean_square, compression._split,
                 tr.Model._cross_kv)
        transform = int8_transform if mesh_name in INT8 else None
        if name == "no_o_reduce":
            attn_mod.row_parallel = _drop_reduce
        elif name == "local_ntok":
            tr._global_ntok = lambda ntok, mesh, axes: ntok.detach()
        elif name == "no_ssd_o_reduce":
            ssm_mod.row_parallel = _drop_reduce
        elif name == "local_norm":
            ssm_mod._mean_square = lambda y, mesh, axis: \
                y.square().mean(-1, keepdim=True)
        elif name == "no_cross_copy_to":
            tr.Model._cross_kv = _without_copy_to(saved[-1])
        else:
            # each shard quantized by its own largest |g|
            compression._split = lambda x, axes: (None, (), 1)
        try:
            with shd.use_ctx(ctx):
                model = build_model(cfg, kv_repeat=ctx.profile.kv_repeat,
                                    device="cpu")
                params = convert.shard_params_from_jax(
                    jax_tree(inputs, kind), model)
                out = _first_batch(model, ctx, params,
                                   batch_at(inputs, kind, 0),
                                   transform=transform)
        finally:
            (attn_mod.row_parallel, tr._global_ntok, ssm_mod.row_parallel,
             ssm_mod._mean_square, compression._split,
             tr.Model._cross_kv) = saved
        if mesh.rank == 0:
            results[f"control/{name}"] = out


#: the families that refused a mesh of more than one rank before they
#: were ported under one, by the reduced config of each: the audio
#: family, the same config as the enc-dec family, and the VLM
FRONTENDS = {"audio": ("seamless-m4t-medium", {}),
             "encdec": ("seamless-m4t-medium", {"family": "encdec"}),
             "vlm": ("internvl2-76b", {})}
#: the families that build under one since the SSD block splits
BUILT = {"ssm": "mamba2-780m", "hybrid": "hymba-1.5b"}


def _raises(fn):
    try:
        fn()
    except NotImplementedError:
        return True
    return False


#: ``kv_valid_len`` under the (1, 2) mesh: each row's count of valid keys
KV_LENS = (S, 13)


def _kv_len_layer(model, params, ctx):
    """The dense model's layer 0 with ``kv_valid_len`` ``KV_LENS`` on
    seeded inputs: (its output, the gradient of the summed squares with
    respect to x), under ``ctx`` (None: one process)."""
    from repro_torch.models import transformer as TT
    x = torch.from_numpy(np.random.default_rng(17).normal(
        size=(2, S, model.cfg.d_model)).astype(np.float32))
    x.requires_grad_(True)
    with shd.use_ctx(ctx):
        lp = model._split(params)["layers"][0]
        y, _, _ = TT._layer_forward(
            lp, x, cfg=model.cfg, positions=torch.arange(S).expand(2, S),
            window=0, kv_repeat=model.kv_repeat,
            kv_valid_len=torch.tensor(KV_LENS))
        gx, = torch.autograd.grad(y.square().sum(), [x])
    return y.detach().numpy(), gx.numpy()


def _refusals(inputs, results):
    """Under a (1, 2) mesh on ranks 0-1: every family builds and draws a
    shard of every parameter that ``specs()`` names; what refused to run
    before runs: ``kv_valid_len`` (its layer's output and input gradient
    beside the one-process layer's), a dense model's ``decode_step``
    under the train rules (the stored KV heads split over ``model``) and
    its ``prefill`` into a sequence-sharded cache (the decode rules)."""
    cfg, mesh, ctx = _context("dense", (1, 2), (0, 1))
    if not mesh.member:
        return
    raised, built, frontends = {}, {}, {}

    def draws(arch, kw):
        model = build_model(dataclasses.replace(reduced(get_config(arch)),
                                                **kw), device="cpu")
        return sorted(model.init(torch.Generator().manual_seed(0))) == \
            sorted(model.specs())
    with shd.use_ctx(ctx):
        for key, (arch, kw) in FRONTENDS.items():
            frontends[key] = draws(arch, kw)
        for key, arch in BUILT.items():
            built[key] = draws(arch, {})
        model = build_model(cfg, kv_repeat=ctx.profile.kv_repeat,
                            device="cpu")
        model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(2, S)
        raised["decode_step"] = _raises(lambda: model.decode_step(
            None, torch.zeros((2, 1), dtype=torch.long), cache))
        params = convert.shard_params_from_jax(jax_tree(inputs, "dense"),
                                               model)
    raised["kv_valid_len"] = _raises(lambda: results.update(
        kv_len_mesh=_kv_len_layer(model, params, ctx)))
    mesh_cfg = MeshConfig((1, 2), AXES)
    dctx = shd.ShardCtx(mesh, shd.make_rules(cfg, mesh_cfg, 2, S, "decode"),
                        shd.sharding_profile(cfg, mesh_cfg, 2, S, "decode"))
    with shd.use_ctx(dctx):
        model = build_model(cfg, device="cpu")
        model.init(torch.Generator().manual_seed(0))
        raised["prefill_seq_sharded"] = not dctx.profile.kv_seq_shard or \
            _raises(lambda: model.prefill(None, {"tokens": torch.zeros(
                (2, S - 8), dtype=torch.long)}, max_len=S))
    if mesh.rank == 0:
        whole = build_model(cfg, device="cpu")
        results["kv_len_one"] = _kv_len_layer(
            whole, convert.shard_params_from_jax(jax_tree(inputs, "dense"),
                                                 whole), None)
        results["refusals"] = raised
        results["built"] = built
        results["built_frontends"] = frontends
    else:
        results.pop("kv_len_mesh", None)


# ---------------------------------------------------------------- serving
def hand_over(cache, repeat, cap):
    """A gathered prefill cache in the decode layout: its stored KV heads
    (the self and the cross K/V's) without the prefill profile's repeat
    (``repeat_interleave``d heads, so every ``repeat``-th), the self
    cache's slots zero-padded to ``cap`` (the cross cache holds the
    frames)."""
    layers = {}
    for k, t in cache["layers"].items():
        t = t[:, :, :, ::repeat]
        if not k.startswith("cross_"):
            pad = torch.zeros((*t.shape[:2], cap - t.shape[2],
                               *t.shape[3:]), dtype=t.dtype)
            t = torch.cat([t, pad], dim=2)
        layers[k] = t
    return {"pos": cache["pos"].clone(), "layers": layers}


def start_cache(inputs, name, case):
    """The cache a decode case starts from, on both sides: the port's
    one-process prefill of the prompt at the case's capacity (``pos``
    S), made with the inputs."""
    pre = f"start/{name}/{case}/"
    return {"pos": torch.from_numpy(inputs[pre + "pos"]),
            "layers": {k[len(pre):]: torch.from_numpy(inputs[k])
                       for k in inputs.files
                       if k.startswith(pre) and k != pre + "pos"}}


def _start_caches(arrays):
    """``start_cache``'s caches, as arrays of the inputs."""
    out = {}
    for (name, case), v in SERVE.items():
        if not v["steps"]:
            continue
        kind, shape = MESHES[name][:2]
        # a decode under the prefill rules starts from their stored heads
        repeat = shd.sharding_profile(
            port_cfg(kind), MeshConfig(shape, AXES), v["batch"], S,
            "prefill").kv_repeat if v.get("swap") else 1
        model = build_model(port_cfg(kind), kv_repeat=repeat,
                            kv_cache_bits=v["bits"], device="cpu")
        tree = _nest({k[len(kind) + 1:]: a for k, a in arrays.items()
                      if k.startswith(kind + "/")})
        params = convert.shard_params_from_jax(tree, model)
        prompt, _ = prompt_batch(arrays, kind, v["batch"])
        _, cache = model.prefill(params, prompt, max_len=v["cap"])
        pre = f"start/{name}/{case}/"
        out[pre + "pos"] = cache["pos"].numpy()
        out.update({pre + k: t.numpy() for k, t in cache["layers"].items()})
    return out


def _serve_contexts(kind, shape, ranks, v):
    mesh_cfg = MeshConfig(shape, AXES)
    cfg = port_cfg(kind)
    mesh = make_mesh_from_config(mesh_cfg, "cpu", ranks=ranks)
    out = []
    for k, n in (("prefill", S), ("decode", v["cap"])):
        prof = shd.sharding_profile(cfg, mesh_cfg, v["batch"], n, k)
        out.append(shd.ShardCtx(mesh, shd.make_rules(
            cfg, mesh_cfg, v["batch"], n, k), prof))
    return cfg, mesh, out[0], out[1]


def _logits_pspec(ctx):
    return (ctx.profile.batch_axes or None, None, ctx.rules[shd.VOCAB])


def _serve_case(inputs, name, case, control=None):
    """One serving case on this rank: the sharded prefill of S tokens
    (behind the family's stub embeddings; or
    ``prefill_streaming`` in the case's ``chunks``; its logits, next
    tokens and cache gathered), then the decode steps from
    ``start_cache`` placed by ``cache_specs`` on the prompt's next tokens
    (each step's logits and tokens, the last cache, gathered): JAX's
    decode cell starts from the same cache, so that an 8-bit cache's
    codes are the same on both sides. A "swap" case prefills under the
    decode rules and decodes under the prefill rules. ``control`` drops
    the merge's reduce, writes the token on every rank at its clamped
    local slot, drops the SSD ``o`` projection's reduce, or drops
    cross-attention's
    ``o`` reduce."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serve.serve_step import vocab_argmax
    from repro_torch.train.elastic import Placement
    from repro_torch.train.train_step import local_batch
    kind, shape, ranks, _ = MESHES[name]
    v = SERVE[(name, case)]
    cfg, mesh, pctx, dctx = _serve_contexts(kind, shape, ranks, v)
    if not mesh.member:
        return None
    cap = S + prefix_len(kind)
    if v.get("swap"):
        pctx, dctx, cap = dctx, pctx, v["cap"]
    prompt, toks = prompt_batch(inputs, kind, v["batch"])
    out = {}
    if v.get("prefill", True):
        with shd.use_ctx(pctx):
            model = build_model(cfg, kv_repeat=pctx.profile.kv_repeat,
                                kv_cache_bits=v["bits"], device="cpu")
            params = convert.shard_params_from_jax(jax_tree(inputs, kind),
                                                   model)
            lb = local_batch(prompt, pctx)
            if v.get("chunks"):
                logits, cache = model.prefill_streaming(
                    params, lb, chunk=S // v["chunks"])
            else:
                logits, cache = model.prefill(params, lb, max_len=cap)
            out["prefill"] = dict(
                logits=_gather(pctx, logits, _logits_pspec(pctx)),
                tok=_gather(pctx, vocab_argmax(logits),
                            _logits_pspec(pctx)[:2]),
                cache={k: t.numpy() for k, t in convert.gather_cache(
                    cache, model)["layers"].items()})
    if not v["steps"]:
        return out if mesh.rank == 0 else None
    full = start_cache(inputs, name, case)
    saved = (attn_mod.merge_partials, attn_mod.shard_write,
             ssm_mod.row_parallel, attn_mod._cross_decode)
    if control == "no_merge_reduce":
        attn_mod.merge_partials = lambda m, l, acc, rmax, rsum: saved[0](
            m, l, acc, lambda t: t, lambda t: t)
    elif control == "clamped_write":
        def clamped(cache, new, slot, lo):
            local = min(max(slot - lo, 0), cache.shape[1] - 1)
            saved[1](cache, new, local, 0)
        attn_mod.shard_write = clamped
    elif control == "no_ssd_o_reduce":
        ssm_mod.row_parallel = _drop_reduce
    elif control == "no_cross_o_reduce":
        def cross(*args, **kwargs):
            attn_mod.row_parallel = _drop_reduce
            try:
                return saved[3](*args, **kwargs)
            finally:
                attn_mod.row_parallel = real_row
        real_row = attn_mod.row_parallel
        attn_mod._cross_decode = cross
    try:
        with shd.use_ctx(dctx):
            model = build_model(cfg, kv_repeat=dctx.profile.kv_repeat,
                                kv_cache_bits=v["bits"], device="cpu")
            params = convert.shard_params_from_jax(jax_tree(inputs, kind),
                                                   model)
            cache = convert.shard_cache(full, model)
            lgs, tks = [], []
            for i in range(v["steps"]):
                t = local_batch({"tokens": toks[:, S + i:S + i + 1]},
                                dctx)["tokens"]
                lg, cache = model.decode_step(params, t, cache)
                lgs.append(_gather(dctx, lg, _logits_pspec(dctx)))
                tks.append(_gather(dctx, vocab_argmax(lg),
                                   _logits_pspec(dctx)[:2]))
            got = convert.gather_cache(cache, model)
    finally:
        (attn_mod.merge_partials, attn_mod.shard_write,
         ssm_mod.row_parallel, attn_mod._cross_decode) = saved
    out["decode"] = dict(logits=np.stack(lgs), tok=np.stack(tks),
                         pos=int(got["pos"]),
                         cache={k: t.numpy() for k, t in
                                got["layers"].items()},
                         kv_seq_shard=dctx.profile.kv_seq_shard)
    return out if mesh.rank == 0 else None


def _serve_e2e(inputs, name, steps=3):
    """A mesh's greedy serving through the step factories:
    ``make_prefill_step`` at the dense "base" case's capacity, the cache
    handed over, then ``steps`` ``make_decode_step`` steps on the tokens
    they return."""
    from repro_torch.serve.serve_step import make_decode_step, \
        make_prefill_step
    from repro_torch.train.train_step import local_batch
    v = SERVE[("dense22", "base")]
    kind, shape, ranks, _ = MESHES[name]
    cfg, mesh, pctx, dctx = _serve_contexts(kind, shape, ranks, v)
    if not mesh.member:
        return None
    prompt, _ = prompt_batch(inputs, kind, v["batch"])
    tokens = []
    with shd.use_ctx(pctx):
        model = build_model(cfg, kv_repeat=pctx.profile.kv_repeat,
                            device="cpu")
        params = convert.shard_params_from_jax(jax_tree(inputs, kind), model)
        t, cache = make_prefill_step(model, max_len=v["cap"])(
            params, local_batch(prompt, pctx))
        full = hand_over(convert.gather_cache(cache, model),
                         pctx.profile.kv_repeat, v["cap"])
    with shd.use_ctx(dctx):
        model = build_model(cfg, kv_repeat=dctx.profile.kv_repeat,
                            device="cpu")
        params = convert.shard_params_from_jax(jax_tree(inputs, kind), model)
        cache = convert.shard_cache(full, model)
        step = make_decode_step(model)
        for _ in range(steps):
            tokens.append(_gather(dctx, t, _logits_pspec(dctx)[:2]))
            t, cache = step(params, t, cache)
        tokens.append(_gather(dctx, t, _logits_pspec(dctx)[:2]))
        got = convert.gather_cache(cache, model)
    if mesh.rank == 0:
        return dict(tokens=np.stack(tokens), pos=int(got["pos"]),
                    kv_repeat=pctx.profile.kv_repeat,
                    cache={k: t.numpy() for k, t in got["layers"].items()})
    return None


def _serving(inputs, rank, results):
    """Every serving case, the controls and the end-to-end run."""
    for name, case in SERVE:
        results[f"serve/{name}/{case}"] = _serve_case(inputs, name, case)
    for control, (name, case) in SERVE_CONTROLS.items():
        results[f"serve_control/{control}"] = _serve_case(
            inputs, name, case, control)
    for name, key in E2E.items():
        results[key] = _serve_e2e(inputs, name)


def world_rank(rank, inputs_path, ckpt_dir):
    """One rank of the module's world: every mesh, the elastic round trip,
    the controls and the refusals, in one order on every rank."""
    inputs = np.load(inputs_path)
    results = {}
    first = None
    for name in MESHES:
        got = _run_mesh(name, inputs, rank, results)
        if name == "dense22":
            first = got
    _elastic(inputs, first, ckpt_dir, rank, results)
    _controls(inputs, rank, results)
    _refusals(inputs, results)
    _serving(inputs, rank, results)
    return results


# ------------------------------------------------------ the JAX reference
_JAX_STEP = r'''
import os
import sys
# two cores a process, so that the module's processes do not crowd out
# the suite's other workers
os.sched_setaffinity(0, {int(c) for c in
                         os.environ["JAX_STEP_CORES"].split(",")})
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config, reduced
from repro.configs.base import MeshConfig, ShapeConfig
from repro.distributed import sharding as shd
from repro.models.model import build_model
from repro.train.optimizer import adamw_init
from repro.train.train_step import (TrainState, choose_microbatches,
                                    choose_remat_group, make_train_state_specs,
                                    make_train_step)
import dataclasses, json

spec = json.loads(sys.argv[3])
inputs = np.load(sys.argv[1])
out = {}


def nest(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def flat(tree, prefix=""):
    o = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            o.update(flat(v, f"{prefix}{k}/"))
        else:
            o[f"{prefix}{k}"] = np.asarray(v)
    return o


def shardings(mesh, logical, rules):
    return jax.tree.map(
        lambda s: NamedSharding(mesh, shd.logical_to_pspec(s, rules)),
        logical, is_leaf=lambda x: isinstance(x, tuple))


def config(kind):
    """The reduced config of ``kind`` with its overrides (an ``ssm`` or
    ``moe`` dict overrides fields of ``cfg.ssm`` or ``cfg.moe``)."""
    kw = dict(spec["configs"][kind])
    cfg = reduced(get_config(kw.pop("arch")))
    for sub in ("ssm", "moe"):
        if sub in kw:
            kw[sub] = dataclasses.replace(getattr(cfg, sub), **kw[sub])
    return dataclasses.replace(cfg, **kw)


def stub_sharding(mesh, rules, kind):
    """{the batch key of the family's stub embeddings: their sharding},
    (BATCH, None, None) as ``models/model.py:50-57`` places them; {} for
    a family without them."""
    stub = spec["stubs"].get(kind)
    if stub is None:
        return {}
    return {stub: NamedSharding(mesh, shd.logical_to_pspec(
        ("batch", None, None), rules))}


def placed(arr, sh):
    """``arr`` on the mesh under each sharding of ``sh``, by its key."""
    return {k: jax.device_put(jnp.asarray(arr), v) for k, v in sh.items()}


for name, (kind, shape, mu, compress) in spec.get("meshes", {}).items():
    cfg = config(kind)
    b, s = spec["batch"], spec["seq"]
    mesh_cfg = MeshConfig(tuple(shape), ("data", "model"))
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    cell = ShapeConfig("world", s, b, "train")
    # launch/dryrun.py:126-176, executed
    profile = shd.sharding_profile(cfg, mesh_cfg, b, s, "train")
    rules = shd.make_rules(cfg, mesh_cfg, b, s, "train")
    mu_probe = choose_microbatches(cfg, cell, mesh_cfg, profile)
    remat_group = choose_remat_group(cfg, cell, mesh_cfg, profile, mu_probe)
    model = build_model(cfg, kv_repeat=profile.kv_repeat,
                        remat_group=remat_group)
    ctx = shd.ShardCtx(mesh=mesh, rules=rules, profile=profile)
    params = nest({k[len(kind) + 1:]: inputs[k] for k in inputs.files
                   if k.startswith(kind + "/")})
    bspec = NamedSharding(mesh, shd.logical_to_pspec(("batch", None),
                                                     rules))
    with shd.use_ctx(ctx):
        p_sh = shardings(mesh, model.specs(), rules)
        state_sh = shardings(mesh, make_train_state_specs(model), rules)
        stub_sh = stub_sharding(mesh, rules, kind)
        batch_sh = {"tokens": bspec, "targets": bspec, **stub_sh}
        grad_transform = None
        if compress:
            # launch/dryrun.py:163-169
            from repro.train.compression import _int8_roundtrip
            grad_transform = lambda g: jax.tree.map(_int8_roundtrip, g)
        train_step = make_train_step(model, num_microbatches=mu,
                                     grad_transform=grad_transform)

        def step_and_grads(state, batch):
            # the step, and the logits and gradients it starts from (and
            # what the transform makes of them): one program, one compile
            logits, _ = model.train_logits(state.params, batch)
            (loss, m), g = jax.value_and_grad(model.loss, has_aux=True)(
                state.params, batch)
            sent = grad_transform(g) if compress else {}
            new_state, metrics = train_step(state, batch)
            return logits, loss, g, sent, new_state, metrics

        params = jax.device_put(params, p_sh)
        batches = [{"tokens": jax.device_put(
                        jnp.asarray(inputs[f"tokens_{kind}"][i]), bspec),
                    "targets": jax.device_put(
                        jnp.asarray(inputs[f"targets_{kind}"][i]), bspec),
                    **placed(inputs[f"stub_{kind}"][i]
                             if stub_sh else None, stub_sh)}
                   for i in range(spec["steps"])]
        step = jax.jit(step_and_grads, in_shardings=(state_sh, batch_sh),
                       out_shardings=(None, None, p_sh, None, state_sh,
                                      None))
        # placed as the step's output is, so that the second call reuses
        # the first call's program
        state = jax.device_put(
            TrainState(params=params, opt=adamw_init(params)), state_sh)
        losses = []
        for i, bt in enumerate(batches):
            got = step(state, bt)
            if i == 0:
                logits, loss, grads, sent = got[:4]
            state, metrics = got[4:]
            losses.append(float(metrics["loss"]))
    out[f"{name}/logits"] = np.asarray(logits)
    out[f"{name}/loss0"] = np.asarray(loss)
    out[f"{name}/losses"] = np.asarray(losses)
    for k, v in flat(jax.tree.map(np.asarray, grads)).items():
        out[f"{name}/grads/{k}"] = v
    for k, v in flat(jax.tree.map(np.asarray, sent)).items():
        out[f"{name}/sent/{k}"] = v
    for k, v in flat(jax.tree.map(np.asarray, state.params)).items():
        out[f"{name}/params/{k}"] = v
'''


_JAX_SERVE = r'''
from repro.serve.serve_step import make_decode_step, make_prefill_step


def prefill_cell(cfg, mesh, mesh_cfg, params, toks, b, s, bits, pre, kind,
                 swap_cap=0):
    """The prefill cell, launch/dryrun.py:179-187, executed; the prompt
    behind the family's stub embeddings, the capacity its embedding
    length (the VLM's counts the patches). ``swap_cap``: the same under
    the decode rules of that capacity, into a cache of it."""
    kind_rules, n = ("decode", swap_cap) if swap_cap else ("prefill", s)
    prof = shd.sharding_profile(cfg, mesh_cfg, b, n, kind_rules)
    rules = shd.make_rules(cfg, mesh_cfg, b, n, kind_rules)
    model = build_model(cfg, kv_repeat=prof.kv_repeat, kv_cache_bits=bits)
    with shd.use_ctx(shd.ShardCtx(mesh=mesh, rules=rules, profile=prof)):
        p_sh = shardings(mesh, model.specs(), rules)
        bspec = NamedSharding(mesh, shd.logical_to_pspec(("batch", None),
                                                         rules))
        stub_sh = stub_sharding(mesh, rules, kind)
        stub = placed(inputs[f"serve_stub_{kind}"][:b] if stub_sh else None,
                      stub_sh)
        cap = swap_cap or s + (cfg.frontend_tokens if "patch_embeds" in stub
                               else 0)
        pstep = make_prefill_step(model, max_len=cap)

        def prefill(p, batch):
            tok, cache = pstep(p, batch)
            logits, _ = model.prefill(p, batch, max_len=cap)
            return tok, logits, cache

        tok, logits, cache = jax.jit(prefill, in_shardings=(
            p_sh, {"tokens": bspec, **stub_sh}))(
                jax.device_put(params, p_sh),
                {"tokens": jax.device_put(jnp.asarray(toks[:, :s]), bspec),
                 **stub})
    out[f"{pre}/prefill/tok"] = np.asarray(tok)
    out[f"{pre}/prefill/logits"] = np.asarray(logits)
    for k, a in cache["layers"].items():
        out[f"{pre}/prefill/cache/{k}"] = np.asarray(a)


def stream_cell(cfg, mesh, mesh_cfg, params, toks, b, s, chunks, pre):
    """``prefill_streaming`` in ``chunks`` chunks under the prefill rules,
    executed; the next tokens as the prefill step takes them."""
    prof = shd.sharding_profile(cfg, mesh_cfg, b, s, "prefill")
    rules = shd.make_rules(cfg, mesh_cfg, b, s, "prefill")
    model = build_model(cfg, kv_repeat=prof.kv_repeat)
    with shd.use_ctx(shd.ShardCtx(mesh=mesh, rules=rules, profile=prof)):
        p_sh = shardings(mesh, model.specs(), rules)
        bspec = NamedSharding(mesh, shd.logical_to_pspec(("batch", None),
                                                         rules))

        def stream(p, batch):
            logits, cache = model.prefill_streaming(p, batch,
                                                    chunk=s // chunks)
            return jnp.argmax(logits, axis=-1).astype(jnp.int32), logits, \
                cache

        tok, logits, cache = jax.jit(stream, in_shardings=(
            p_sh, {"tokens": bspec}))(jax.device_put(params, p_sh),
                                      {"tokens": jax.device_put(
                                          jnp.asarray(toks[:, :s]), bspec)})
    out[f"{pre}/prefill/tok"] = np.asarray(tok)
    out[f"{pre}/prefill/logits"] = np.asarray(logits)
    for k, a in cache["layers"].items():
        out[f"{pre}/prefill/cache/{k}"] = np.asarray(a)


def decode_cells(cfg, mesh, mesh_cfg, params, toks, b, s, v, host, pre):
    """The decode cell, launch/dryrun.py:188-204, executed with each
    write from ``host``, the cache the port's decode starts from too; a
    "swap" case's under the prefill rules."""
    cap, bits = v["cap"], v["bits"]
    kind_rules = "prefill" if v.get("swap") else "decode"
    dprof = shd.sharding_profile(cfg, mesh_cfg, b, cap, kind_rules)
    drules = shd.make_rules(cfg, mesh_cfg, b, cap, kind_rules)
    out[f"{pre}/kv_seq_shard"] = np.asarray(dprof.kv_seq_shard)
    for dus in map(bool, v.get("dus", (0, 1))):
        dmodel = build_model(cfg, kv_repeat=dprof.kv_repeat,
                             kv_cache_bits=bits, kv_dus_write=dus)
        with shd.use_ctx(shd.ShardCtx(mesh=mesh, rules=drules,
                                      profile=dprof)):
            dp_sh = shardings(mesh, dmodel.specs(), drules)
            cache_sh = shardings(mesh, dmodel.cache_specs(), drules)
            tok_sh = NamedSharding(mesh, shd.logical_to_pspec(
                ("batch", None), drules))
            dstep = make_decode_step(dmodel)

            def decode(p, t, c):
                nt, c2 = dstep(p, t, c)
                lg, _ = dmodel.decode_step(p, t, c)
                return nt, lg, c2

            step = jax.jit(decode, in_shardings=(dp_sh, tok_sh, cache_sh),
                           out_shardings=(None, None, cache_sh))
            dparams = jax.device_put(params, dp_sh)
            c = jax.device_put(jax.tree.map(jnp.asarray, host), cache_sh)
            toks_out, lgs = [], []
            for i in range(v["steps"]):
                nt, lg, c = step(dparams, jax.device_put(
                    jnp.asarray(toks[:, s + i:s + i + 1]), tok_sh), c)
                toks_out.append(np.asarray(nt))
                lgs.append(np.asarray(lg))
        d = f"{pre}/dus{int(dus)}"
        out[f"{d}/tok"] = np.stack(toks_out)
        out[f"{d}/logits"] = np.stack(lgs)
        out[f"{d}/pos"] = np.asarray(c["pos"])
        for k, a in c["layers"].items():
            out[f"{d}/cache/{k}"] = np.asarray(a)


for name, kind, shape, v in spec.get("cells", []):
    cfg = config(kind)
    b, s = v["batch"], spec["seq"]
    mesh_cfg = MeshConfig(tuple(shape), ("data", "model"))
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    params = nest({k[len(kind) + 1:]: inputs[k] for k in inputs.files
                   if k.startswith(kind + "/")})
    toks = np.asarray(inputs[f"serve_tokens_{kind}"][:b])
    pre = f"{name}/{v['tag']}"
    if v.get("chunks"):
        stream_cell(cfg, mesh, mesh_cfg, params, toks, b, s, v["chunks"],
                    pre)
    elif v.get("prefill", True):
        prefill_cell(cfg, mesh, mesh_cfg, params, toks, b, s, v["bits"], pre,
                     kind, v["cap"] if v.get("swap") else 0)
    if v["steps"]:
        start = f"start/{pre}/"
        host = {"pos": np.asarray(inputs[start + "pos"]),
                "layers": {k[len(start):]: inputs[k] for k in inputs.files
                           if k.startswith(start) and k != start + "pos"}}
        decode_cells(cfg, mesh, mesh_cfg, params, toks, b, s, v, host, pre)
'''
#: the end of the JAX program: everything it computed, saved
_JAX_END = r'''
np.savez(sys.argv[2], **out)
print("ok", len(jax.devices()))
'''


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX weights and batches, the world's results, the JAX sharded
    step's and the port's one-process step's, for every mesh."""
    import jax
    from repro.configs import get_config as j_get_config, reduced as j_reduced
    from repro.models.model import build_model as j_build_model
    from repro_torch.data.generators import token_batches

    tmp = tmp_path_factory.mktemp("lm_world")

    def jax_init(kind):
        kw = dict(CONFIGS[kind])
        jcfg = _with(j_reduced(j_get_config(kw.pop("arch"))), kw)
        return jcfg, jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(7))

    # the configs' compiles overlap (XLA compiles outside the GIL)
    with ThreadPoolExecutor(4) as pool:
        inits = dict(zip(CONFIGS, pool.map(jax_init, CONFIGS)))
    arrays = {}
    for kind, (jcfg, jparams) in inits.items():
        arrays.update({f"{kind}/{k}": v for k, v in
                       _flat(jax.tree.map(np.asarray, jparams)).items()})
        gen = token_batches(jcfg.vocab_size, B, S, seed=11)
        bs = [next(gen) for _ in range(2 * STEPS)]
        toks = np.stack([b["tokens"] for b in bs])
        tgts = np.stack([b["targets"] for b in bs])
        tgts[:, 0, :9] = -1     # the first data shard counts fewer tokens
        arrays[f"tokens_{kind}"], arrays[f"targets_{kind}"] = toks, tgts
        arrays[f"serve_tokens_{kind}"] = np.random.default_rng(5).integers(
            0, jcfg.vocab_size, (B, S + 8)).astype(np.int32)
        if kind in STUBS:
            # normal x 0.02, as test_torch_encdec.py draws the frames
            rng = np.random.default_rng(13)
            f = (B, jcfg.frontend_tokens, jcfg.d_model)
            arrays[f"stub_{kind}"] = (rng.normal(size=(2 * STEPS, *f))
                                      * 0.02).astype(np.float32)
            arrays[f"serve_stub_{kind}"] = (rng.normal(size=f)
                                            * 0.02).astype(np.float32)
    arrays.update(_start_caches(arrays))
    inputs_path = tmp / "inputs.npz"
    np.savez(inputs_path, **arrays)

    import json
    import threading
    script = tmp / "jax_step.py"
    script.write_text(_JAX_STEP + _JAX_SERVE + _JAX_END)
    root = Path(__file__).resolve().parents[1]
    # the JAX programs compile with LLVM's backend optimizations off:
    # compiling, not running, is most of their processes' time
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0"}
    procs = []
    cores = sorted(os.sched_getaffinity(0))
    # one process a JAX_GROUPS key: its meshes' train steps, then its
    # SERVE_GROUPS cells
    for i, n in enumerate(JAX_GROUPS):
        spec = {"meshes": {m: (MESHES[m][0], list(MESHES[m][1]),
                               MESHES[m][3], m in INT8)
                           for m in JAX_GROUPS[n]},
                "cells": [[m, MESHES[m][0], list(MESHES[m][1]),
                           dict(SERVE[(m, c)], tag=c)]
                          for m, c in SERVE_GROUPS[n]],
                "configs": CONFIGS, "stubs": STUBS, "batch": B, "seq": S,
                "steps": STEPS}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(inputs_path),
             str(tmp / f"jax{i}.npz"), json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**env, "JAX_STEP_CORES": ",".join(str(cores[j % len(cores)])
                                                   for j in (2 * i,
                                                             2 * i + 1))}))
    ranks = {}

    def run_world():
        try:
            ranks["out"] = spawn_world(world_rank, WORLD,
                                       (str(inputs_path), str(tmp / "ckpt")),
                                       timeout_s=TIMEOUT_S,
                                       workdir=tmp / "world")
        except BaseException as e:   # raised below, in the test's thread
            ranks["error"] = e

    world_thread = threading.Thread(target=run_world)
    world_thread.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = one_process(np.load(inputs_path))
        world_thread.join(TIMEOUT_S)
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if "error" in ranks:
        raise ranks["error"]
    assert "out" in ranks, "the world did not finish"
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.split() == ["ok", "4"]
    got = {}
    for r in ranks["out"]:
        got.update({k: v for k, v in r.items() if v is not None})
    want = {}
    for i in range(len(procs)):
        with np.load(tmp / f"jax{i}.npz") as z:
            want.update({k: z[k] for k in z.files})
    jax_ref = {}
    for name in MESHES:
        if name in WORLD_ONLY:
            continue

        def sub(tag):
            pre = f"{name}/{tag}/"
            return convert.model_params_from_jax(_nest(
                {k[len(pre):]: want[k] for k in want
                 if k.startswith(pre)}))
        jax_ref[name] = dict(
            logits=want[f"{name}/logits"], loss0=float(want[f"{name}/loss0"]),
            losses=list(want[f"{name}/losses"]),
            grads={n: t.numpy() for n, t in sub("grads").items()},
            sent={n: t.numpy() for n, t in sub("sent").items()},
            params={n: t.numpy() for n, t in sub("params").items()})
    for name, case in SERVE:
        pre = f"{name}/{case}/"
        jax_ref[f"serve/{name}/{case}"] = {
            k[len(pre):]: want[k] for k in want if k.startswith(pre)}
    return dict(got=got, jax=jax_ref, one=one, inputs_path=inputs_path)


def one_process(inputs):
    """The port's one-process logits, loss, gradients and steps (four for
    the elastic reference), for each config and micro-batch depth."""
    out = {}
    for name, (kind, shape, _, mu) in MESHES.items():
        cfg = port_cfg(kind)
        prof = shd.sharding_profile(cfg, MeshConfig(shape, AXES), B, S)
        model = build_model(cfg, kv_repeat=prof.kv_repeat, device="cpu")
        params = convert.shard_params_from_jax(jax_tree(inputs, kind), model)
        b0 = batch_at(inputs, kind, 0)
        with torch.no_grad():
            logits, _ = model.train_logits(params, b0)
        loss, _ = model.loss(params, b0)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        rec = dict(logits=logits.numpy(), loss0=float(loss),
                   grads={n: g.numpy() for n, g in grads.items()})
        transform = int8_transform if name in INT8 else None
        if transform is not None:
            rec["sent"] = {n: g.numpy() for n, g in transform(grads).items()}
        state = TrainState(params=params, opt=adamw_init(params))
        step = make_train_step(model, num_microbatches=mu,
                               grad_transform=transform)
        n_steps = 2 * STEPS if name == "dense22" else STEPS
        losses = []
        for i in range(n_steps):
            state, m = step(state, batch_at(inputs, kind, i))
            losses.append(float(m["loss"]))
            if i == STEPS - 1:
                rec["params"] = {n: t.detach().numpy().copy()
                                 for n, t in state.params.items()}
        rec["losses"] = losses[:STEPS]
        if name == "dense22":
            rec["elastic"] = dict(losses=losses[STEPS:], params={
                n: t.detach().numpy() for n, t in state.params.items()})
        out[name] = rec
    for name, key in E2E.items():
        out[key] = _serve_e2e_one_process(inputs, MESHES[name][0])
    return out


def _serve_e2e_one_process(inputs, kind, steps=3):
    """``_serve_e2e`` in one process: the same factories, one model."""
    from repro_torch.serve.serve_step import make_decode_step, \
        make_prefill_step
    v = SERVE[("dense22", "base")]
    model = build_model(port_cfg(kind), device="cpu")
    params = convert.shard_params_from_jax(jax_tree(inputs, kind), model)
    prompt, _ = prompt_batch(inputs, kind, v["batch"])
    t, cache = make_prefill_step(model, max_len=v["cap"])(params, prompt)
    tokens = []
    step = make_decode_step(model)
    for _ in range(steps):
        tokens.append(t.numpy())
        t, cache = step(params, t, cache)
    tokens.append(t.numpy())
    return dict(tokens=np.stack(tokens), pos=int(cache["pos"]),
                cache={k: t.numpy() for k, t in cache["layers"].items()})


# ----------------------------------------------------------------- checks
def _close(got, want, what):
    """test_model_matches_jax_float32's tolerance: rtol 1e-3 with atol
    1e-5 of the reference's largest magnitude, name by name."""
    assert set(got) == set(want), what
    for n in want:
        scale = float(np.abs(want[n]).max())
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=f"{what}: {n}")


def _updates_close(got, want, before, what):
    """Each parameter's update within 1% of its norm
    (``test_torch_train.py::_assert_update``)."""
    assert set(got) == set(want) == set(before), what
    for n, w in want.items():
        err = np.linalg.norm(got[n] - w)
        assert err <= 1e-2 * np.linalg.norm(w - before[n]), (what, n, err)


def _initial(world, kind):
    inputs = np.load(world["inputs_path"])
    return {n: t.numpy() for n, t in
            convert.model_params_from_jax(jax_tree(inputs, kind)).items()}


def _hold(world, got, want, what):
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=1e-4, err_msg=what)
    assert abs(got["loss0"] - want["loss0"]) <= 1e-5, what
    _close(got["grads"], want["grads"], f"{what} gradients")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5, err_msg=what)
    kind = MESHES[what.split()[0]][0]
    _updates_close(got["params"], want["params"], _initial(world, kind),
                   f"{what} parameters")


@pytest.mark.parametrize("ref,name", [
    (ref, n) for ref in ("jax", "one") for n in MESHES
    if n != "moe22" and not (ref == "jax" and n in WORLD_ONLY)])
def test_world_matches_reference(world, name, ref):
    """Logits, loss, gradients, the two steps' losses and the updated
    parameters of each dense, SSM and hybrid mesh against JAX's executed
    sharded step and against the port's one-process step (the both-TP
    hybrid against the latter alone)."""
    _hold(world, world["got"][name], world[ref][name], f"{name} vs {ref}")


#: each new mesh's layout, as ``sharding_profile`` gives it: attention,
#: SSD and MLP split over ``model`` or whole on every rank, and the KV
#: repeat
LAYOUTS = {"ssm22": dict(attn_tp=False, ssd_tp=True, mlp_tp=False,
                         kv_repeat=1),
           "ssm14": dict(attn_tp=False, ssd_tp=True, mlp_tp=False,
                         kv_repeat=1),
           "hyb22": dict(attn_tp=False, ssd_tp=True, mlp_tp=True,
                         kv_repeat=1),
           "hyb14": dict(attn_tp=False, ssd_tp=False, mlp_tp=True,
                         kv_repeat=1),
           "hybtp22": dict(attn_tp=True, ssd_tp=True, mlp_tp=True,
                           kv_repeat=2)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_ssm_and_hybrid_meshes_take_their_layouts(world, name):
    """The layouts the published models need: the SSD block split, the
    hybrid's attention DP-only beside a split SSD block (hyb22) or both
    DP-only beside a split MLP (hyb14), and both branches split with the
    KV head repeated (hybtp22)."""
    assert world["got"][name]["profile"] == LAYOUTS[name]


def _hold_int8(got, want, what):
    """Each JAX leaf's int8 round trip against the reference's: the
    largest magnitude of its layers (127 times the scale) within 1e-3 of
    the reference's, the codes by the reference's scale equal but for
    one-step moves on at most ``INT8_MOVED`` of them."""
    from repro_torch.train.compression import leaves
    assert set(got) == set(want), what
    for names in leaves(want).values():
        top = max(max(float(np.abs(want[n]).max()) for n in names), 1e-30)
        mine = max(float(np.abs(got[n]).max()) for n in names)
        assert abs(mine - top) <= 1e-3 * top, (what, names[0])
        for n in names:
            moved = np.abs(np.round(got[n] * 127 / top)
                           - np.round(want[n] * 127 / top))
            assert moved.max() <= 1 and moved.mean() <= INT8_MOVED, \
                (what, n, float(moved.max()), float(moved.mean()))


@pytest.mark.parametrize("ref", ["jax", "one"])
@pytest.mark.parametrize("name", INT8)
def test_int8_grad_transform_matches_reference(world, name, ref):
    """The int8 ``grad_transform`` of the sharded first batch (each
    rank's slice by the scale of the whole tensor) against JAX's
    transform of its global gradient and the port's one-process one."""
    _hold_int8(world["got"][name]["sent"], world[ref][name]["sent"],
               f"{name} vs {ref}")


@pytest.mark.parametrize("kind", list(COMPRESSORS))
@pytest.mark.parametrize("name", COMPRESS)
def test_sharded_compression_equals_the_transform_of_the_whole(world, name,
                                                               kind):
    """Two rounds of ``compress_grads`` on each rank's shards of the
    reduced gradients (the int8 scale and the top-k threshold of the
    whole tensor, the error feedback kept sharded), gathered: bit for bit
    the one-process rounds on the gathered gradients."""
    got = world["got"][name]
    grads = {n: torch.from_numpy(g) for n, g in got["grads"].items()}
    want = compress_rounds(grads, kind)
    for key, tree in want.items():
        assert set(got["compress"][kind][key]) == set(tree)
        for n, t in tree.items():
            np.testing.assert_array_equal(got["compress"][kind][key][n],
                                          t.numpy(), err_msg=f"{key} {n}")


def test_moe_world_matches_jax_sharded_step(world):
    """The MoE mesh against JAX's sharded step only: JAX's expert
    parallelism takes each expert's capacity from the data shard's token
    count, which the one-process step computes from the whole batch."""
    _hold(world, world["got"]["moe22"], world["jax"]["moe22"], "moe22")


def test_moe_layers_match_one_process_moe_forward_per_data_shard(world):
    """Each rank's expert-parallel ``moe_forward``, layer by layer,
    against the one-process ``moe_forward`` of the same data shard's
    tokens with the full weights (JAX's EP semantics: capacity from the
    local count, each expert's top-C among those tokens)."""
    from repro_torch.models.moe import moe_forward
    inputs = np.load(world["inputs_path"])
    cfg = port_cfg("moe")
    full = convert.model_params_from_jax(jax_tree(inputs, "moe"))
    records = {k: v for k, v in world["got"].items() if "/moe_io/" in k}
    assert len(records) == WORLD
    assert {r["data"] for r in records.values()} == {0, 1}
    for key, rec in records.items():
        assert len(rec["io"]) == cfg.num_layers
        for layer, (x, y) in enumerate(rec["io"]):
            p = {"router": {"w": full[f"layers.{layer}.moe.router.w"]},
                 **{w: full[f"layers.{layer}.moe.{w}"]
                    for w in ("wg", "wu", "wd")}}
            with torch.no_grad():
                want, _ = moe_forward(p, torch.from_numpy(x), cfg)
            np.testing.assert_allclose(y, want.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{key} {layer}")


def test_elastic_round_trip_equals_four_one_process_steps(world):
    """Two steps on (2, 2), a checkpoint of the full arrays, the restore
    onto (1, 2) through ``elastic_reshard`` and two more steps: the
    losses and parameters of four one-process steps."""
    got, want = world["got"]["elastic"], world["one"]["dense22"]["elastic"]
    assert got["step"] == 2 * STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    _updates_close(got["params"], want["params"], _initial(world, "dense"),
                   "elastic parameters")


def test_refusals_under_a_mesh(world):
    """Under a (1, 2) mesh nothing raises ``NotImplementedError`` any
    more: ``kv_valid_len``, ``decode_step`` under the train rules and
    ``prefill`` into a sequence-sharded cache all run (the layouts held
    to JAX's cells in the "swap" serving cases); every family builds and
    draws every parameter's shard. A dense layer with ``kv_valid_len``
    ``KV_LENS`` (its key head repeated x2 and sliced) meets the
    one-process layer: its output and its input's gradient at
    ``_close``'s tolerance."""
    assert world["got"]["refusals"] == {"kv_valid_len": False,
                                        "decode_step": False,
                                        "prefill_seq_sharded": False}
    assert world["got"]["built_frontends"] == {"audio": True,
                                               "encdec": True, "vlm": True}
    got, want = world["got"]["kv_len_mesh"], world["got"]["kv_len_one"]
    _close({"y": got[0], "gx": got[1]}, {"y": want[0], "gx": want[1]},
           "kv_valid_len under (1, 2)")


#: each frontend and MoE mesh's layout, as ``sharding_profile`` gives it:
#: the GQA audio's cross heads and the VLM's KV head repeated x2
FRONTEND_LAYOUTS = {
    "aud22": dict(attn_tp=True, ssd_tp=False, mlp_tp=True, kv_repeat=1),
    "audgqa14": dict(attn_tp=True, ssd_tp=False, mlp_tp=True, kv_repeat=2),
    "encdec22": dict(attn_tp=True, ssd_tp=False, mlp_tp=True, kv_repeat=1),
    "vlm22": dict(attn_tp=True, ssd_tp=False, mlp_tp=True, kv_repeat=2),
    "moe522": dict(attn_tp=True, ssd_tp=False, mlp_tp=True, kv_repeat=2)}


@pytest.mark.parametrize("name", list(FRONTEND_LAYOUTS))
def test_frontend_and_moe_meshes_take_their_layouts(world, name):
    """The frontend meshes split attention and the MLP over ``model``,
    repeating the KV heads where they do not divide it; the MoE mesh with
    5 experts takes no expert parallelism (JAX's global-token branch)."""
    got = world["got"][name]
    assert got["profile"] == FRONTEND_LAYOUTS[name]
    assert got["expert_tp"] is False


def test_ssm_and_hybrid_build_under_a_mesh(world):
    """The SSM and hybrid families build under the same (1, 2) mesh and
    draw a shard of every parameter that ``specs()`` names."""
    assert world["got"]["built"] == {"ssm": True, "hybrid": True}


@pytest.mark.parametrize("control", CONTROLS)
def test_control_fails_the_comparison(world, control):
    """A mesh's first batch without the attention or SSD ``o``
    projection's ``model`` reduce, with the CE over the local token count,
    or with the gated norm over each rank's heads alone, must not meet
    the one-process gradients; with the int8 scale of each shard, the
    transform must not meet JAX's."""
    name = CONTROLS[control]
    got = world["got"][f"control/{control}"]
    with pytest.raises(AssertionError):
        if name in INT8:
            _hold_int8(got["sent"], world["jax"][name]["sent"], control)
        else:
            want = world["one"][name]
            assert abs(got["loss0"] - want["loss0"]) <= 1e-5
            _close(got["grads"], want["grads"], control)


#: the share of an 8-bit cache's codes that may sit one step from the
#: reference's: float32 K/V that differ in their last bits round to the
#: neighbouring code where they lie at a half step (2 of 32,768 codes of
#: the (2, 2) prefill)
INT8_MOVED = 1e-3


def _hold_serving(got, want, what):
    """Logits, next tokens and cache leaves at the float32 tolerance of
    ``_close``; the tokens exact; an int8 leaf's codes equal but for
    one-step moves on at most ``INT8_MOVED`` of them."""
    _close({"logits": got["logits"]}, {"logits": want["logits"]}, what)
    np.testing.assert_array_equal(got["tok"], want["tok"], err_msg=what)
    assert set(got["cache"]) == set(want["cache"]), what
    floats = {}
    for k, w in want["cache"].items():
        g = got["cache"][k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if w.dtype == np.int8:
            moved = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert moved.max() <= 1 and moved.mean() <= INT8_MOVED, \
                (what, k, int(moved.max()), float(moved.mean()))
        else:
            floats[k] = k
    _close({k: got["cache"][k] for k in floats},
           {k: want["cache"][k] for k in floats}, f"{what} cache")


def _jax_cells(world, name, case):
    want = world["jax"][f"serve/{name}/{case}"]
    prefill = None
    if "prefill/logits" in want:
        prefill = {"logits": want["prefill/logits"],
                   "tok": want["prefill/tok"],
                   "cache": {k[len("prefill/cache/"):]: a
                             for k, a in want.items()
                             if k.startswith("prefill/cache/")}}
    decode = {}
    for dus in SERVE[(name, case)].get("dus", (0, 1)) \
            if SERVE[(name, case)]["steps"] else ():
        pre = f"dus{dus}/"
        decode[dus] = {"logits": want[pre + "logits"],
                       "tok": want[pre + "tok"], "pos": int(want[pre + "pos"]),
                       "cache": {k[len(pre + "cache/"):]: a
                                 for k, a in want.items()
                                 if k.startswith(pre + "cache/")}}
    return prefill, decode, bool(want.get("kv_seq_shard", False))


@pytest.mark.parametrize("name,case", [k for k, v in SERVE.items()
                                       if v.get("prefill", True)])
def test_sharded_prefill_matches_jax(world, name, case):
    """The sharded prefill (the prefill rules: each rank's stored KV heads,
    its vocab shard of the logits; a "swap" case's under the decode rules,
    straight into the sequence-sharded cache of the case's capacity)
    against JAX's executed prefill cell: the gathered logits, the
    vocab-parallel argmax's tokens and the gathered cache."""
    got = world["got"][f"serve/{name}/{case}"]["prefill"]
    prefill, _, _ = _jax_cells(world, name, case)
    _hold_serving(got, prefill, f"{name} {case} prefill")


@pytest.mark.parametrize("name,case,dus", [
    (*k, dus) for dus in (0, 1) for k, v in SERVE.items()
    if v["steps"] and dus in v.get("dus", (0, 1))])
def test_context_parallel_decode_matches_jax(world, name, case, dus):
    """The decode steps under the decode rules (the cache sequence-sharded
    over ``model``, the partials merged across it; whole on every rank
    where the capacity does not divide ``model``) from one start cache,
    against JAX's executed decode cell with the masked write (``kv_dus``
    False) and with ``_shard_map_dus_write`` (True): each step's logits
    and tokens, the last cache and ``pos``. A "swap" case decodes under
    the prefill rules (head-parallel, each rank's stored heads and every
    slot) against JAX's decode cell built with those rules."""
    got = world["got"][f"serve/{name}/{case}"]["decode"]
    _, decode, kv_seq_shard = _jax_cells(world, name, case)
    assert got["kv_seq_shard"] == kv_seq_shard == \
        SERVE[(name, case)].get("seq_shard", True)
    assert got["pos"] == decode[dus]["pos"] == \
        prefix_len(MESHES[name][0]) + S + SERVE[(name, case)]["steps"]
    _hold_serving(got, decode[dus], f"{name} {case} decode dus={dus}")


def test_decode_past_capacity_writes_nothing(world):
    """At ``pos == S_cache`` no slice of a sequence-sharded cache holds
    the slot: the cache after the step is the handed-over prefill cache,
    as in JAX, where one device (the port's one-process decode) clamps
    the slot and overwrites the last one."""
    got = world["got"]["serve/dense22/full"]
    inputs = np.load(world["inputs_path"])
    start = start_cache(inputs, "dense22", "full")
    for k, a in got["decode"]["cache"].items():
        np.testing.assert_array_equal(a, start["layers"][k].numpy(),
                                      err_msg=k)
    model = build_model(port_cfg("dense"), device="cpu")
    params = convert.shard_params_from_jax(jax_tree(inputs, "dense"), model)
    toks = torch.from_numpy(inputs["serve_tokens_dense"])
    _, cache = model.prefill(params, {"tokens": toks[:, :S]}, max_len=S)
    before = cache["layers"]["k"].clone()
    model.decode_step(params, toks[:, S:S + 1], cache)
    assert not torch.equal(cache["layers"]["k"][:, :, -1], before[:, :, -1])
    assert torch.equal(cache["layers"]["k"][:, :, :-1], before[:, :, :-1])


@pytest.mark.parametrize("control", SERVE_CONTROLS)
def test_serving_control_fails_the_comparison(world, control):
    """(2, 2)'s decode with the merge's ``model`` reduce dropped (each
    rank attends only its slice), or with every rank writing the token at
    its clamped local slot, and the hybrid's with the SSD ``o``
    projection's reduce dropped, must not meet JAX's decode cell."""
    got = world["got"][f"serve_control/{control}"]["decode"]
    _, decode, _ = _jax_cells(world, *SERVE_CONTROLS[control])
    with pytest.raises(AssertionError):
        _hold_serving(got, decode[0], control)


def test_serving_end_to_end_matches_one_process(world):
    """``make_prefill_step`` on the (2, 2) mesh, the cache handed over to
    the decode layout, then three greedy ``make_decode_step`` steps on
    the tokens they return: the tokens, ``pos`` and the last cache of the
    port's one-process run."""
    got, want = world["got"]["serve_e2e"], world["one"]["serve_e2e"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["pos"] == want["pos"] == S + 3
    _close(got["cache"], want["cache"], "end-to-end cache")


def test_cross_cache_hand_over_end_to_end_matches_one_process(world):
    """The audio GQA (1, 4) through the step factories: its prefill
    repeats the 2 cross K/V heads x2 and keeps one repeated head a rank;
    the hand-over gathers them by ``cache_specs`` and takes every second
    one, the decode layout holds them whole on every rank. The greedy
    tokens, ``pos`` and the last cache (the cross K/V among it) are the
    port's one-process run's."""
    got = world["got"][E2E["audgqa14"]]
    want = world["one"][E2E["audgqa14"]]
    assert got["kv_repeat"] == 2
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["pos"] == want["pos"] == S + 3
    assert {"cross_k", "cross_v"} <= set(want["cache"])
    _close(got["cache"], want["cache"], "end-to-end cache")


def _fails_on_rank_1(rank):
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.all_reduce(torch.zeros(1))     # rank 1 never joins it
    return rank


def test_a_failing_rank_fails_the_world_within_its_deadline(tmp_path):
    """A rank that raises fails the world with its traceback, and the rank
    left waiting in a collective is terminated, well inside the world's
    deadline: no world can hang the suite."""
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="rank 1 fails"):
        spawn_world(_fails_on_rank_1, 2, timeout_s=60.0, workdir=tmp_path)
    assert time.monotonic() - t0 < 60.0


def _fails_on_rank_1_slow_exit(rank, err_path):
    """Rank 1 raises; once its error file is written, it closes its
    process group, which fails rank 0's waiting ``all_reduce`` at once,
    and holds its own exit for 3 s: rank 0 exits first."""
    import threading
    import torch.distributed as dist

    def close_then_linger():
        while not os.path.exists(err_path):
            time.sleep(0.01)
        dist.destroy_process_group()
        time.sleep(3.0)

    if rank == 1:
        threading.Thread(target=close_then_linger).start()
        raise RuntimeError("rank 1 fails")
    dist.all_reduce(torch.zeros(1))     # fails when rank 1 closes its group
    return rank


def test_the_first_failure_is_named_first_when_a_waiting_rank_exits_first(
        tmp_path):
    """The race of a failing rank against the rank it leaves waiting: the
    waiting rank's collective fails and it exits before the failing rank
    does. The world still names the failing rank's error, and names it
    first, well inside its deadline."""
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="rank 1 fails") as err:
        spawn_world(_fails_on_rank_1_slow_exit, 2,
                    (str(tmp_path / "result.1.err"),), timeout_s=60.0,
                    workdir=tmp_path)
    text = str(err.value)
    assert time.monotonic() - t0 < 60.0
    # rank 0's traceback is in the message too, after rank 1's
    assert text.index("rank 1 fails") < text.index("all_reduce"), text
