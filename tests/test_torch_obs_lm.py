"""The LM path's spans and counters (``repro_torch.obs.lm``) on the
reduced starcoder2-7b, on the CPU: the tracer off changes no output and
records nothing; on, one train step, one prefill and one decode step give
the span tree of ``train_step``, ``Model.loss``, ``prefill``,
``decode_step`` and the attention kernels' entry points (a recompute's
spans marked); ``host_syncs`` counts the decode's read of ``pos`` and
nothing else; ``cast_bytes`` counts the stored bytes of every parameter
converted; and under ``torch.profiler`` each span is in the trace as
``repro:<name>`` at its own start (the engine's tracer adds no
annotation). The other families' spans: the reduced hymba-1.5b's
attention and SSD heads apart (``model.attn``, ``model.ssd``), the
reduced seamless-m4t-medium's ``model.encoder`` and ``model.xattn``, and
a train step on a (1, 2) mesh of a fake world with a gradient transform
(``train.reduce``, ``train.transform``). The last test needs a card: the
device clock (``device_s``, the head's ``device_bwd_s``).
"""
import dataclasses
import json
import os
import tempfile

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import FAMILY_AUDIO, MeshConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.obs import lm
from repro_torch.obs.trace import Tracer
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.train_step import init_train_state

B, S, CAP = 2, 32, 40
HYBRID, AUDIO = "hymba-1.5b", "seamless-m4t-medium"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(remat="none", device="cpu", arch="starcoder2-7b"):
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=remat)
    return build_model(cfg, device=device)


def _batch(cfg, device="cpu"):
    """Tokens and targets; the audio family's stub frames too."""
    g = torch.Generator().manual_seed(1)
    rows = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
    if cfg.family == FAMILY_AUDIO:
        batch["frame_embeds"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.d_model), generator=g) * 0.02
    return {k: v.to(device) for k, v in batch.items()}


def _run(model, device="cpu"):
    """One train step, then a prefill and two decode steps from the
    trained parameters: every output, cloned."""
    state = init_train_state(model, torch.Generator(device=device)
                             .manual_seed(0))
    batch = _batch(model.cfg, device)
    state, metrics = make_train_step(model, OptConfig())(state, batch)
    out = {"loss": metrics["loss"].clone(),
           "grad_norm": metrics["grad_norm"].clone()}
    out.update({n: p.detach().clone() for n, p in state.params.items()})
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    tok, cache = make_prefill_step(model, CAP)(state.params, prompt)
    out["prefill"] = tok.clone()
    decode = make_decode_step(model)
    for i in range(2):
        tok, cache = decode(state.params, tok, cache)
        out[f"decode{i}"] = tok.clone()
    out.update({f"cache.{n}": t.clone()
                for n, t in cache["layers"].items()})
    return out


def _traced(remat="none", arch="starcoder2-7b"):
    with lm.tracing("cpu") as tr:
        _run(_model(remat, arch=arch))
        return tr.records()


def _tree(records):
    """(name, parent's name, attrs) of every record, in finish order."""
    by_id = {r["span"]: r for r in records}
    return [(r["name"], by_id[r["parent"]]["name"] if r["parent"] else None,
             r["attrs"]) for r in records]


def _roots(records, name):
    return [r for r in records if r["parent"] is None and r["name"] == name]


def _family(records, root):
    return [r for r in records if r["trace"] == root["trace"]]


def _under(records, root, parent):
    """(name, layer) of the spans under ``parent`` in the first trace whose
    root is ``root``, in finish order."""
    r = _roots(records, root)[0]
    return [(n, a.get("layer")) for n, p, a in _tree(_family(records, r))
            if p == parent]


def _layers(names, n=2):
    return [(name, i) for i in range(n) for name in names]


def test_tracer_off_changes_nothing_and_records_nothing():
    started = lm.TRACER.stats()["spans_started"]
    lm.TRACER.clear()
    off = _run(_model())
    assert lm.TRACER.records() == []
    assert lm.TRACER.stats()["spans_started"] == started
    with lm.tracing("cpu"):
        on = _run(_model())
    assert not lm.TRACER.enabled
    assert off.keys() == on.keys()
    for name in off:
        assert torch.equal(off[name], on[name]), name


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_span_tree(remat):
    recs = _traced(remat)
    (root,) = _roots(recs, "train.step")
    tree = _tree(_family(recs, root))
    L = 2
    fwd = [(n, a.get("layer")) for n, p, a in tree if p == "train.fwd"]
    assert fwd == [("model.embed", None)] + [
        (name, i) for i in range(L) for name in ("model.attn", "model.mlp")
    ] + [("model.head", None)]
    assert [n for n, p, _ in tree if p == "train.step"] == [
        "train.fwd", "train.bwd", "train.opt"]
    k5 = [(p, a.get("recompute", False)) for n, p, a in tree
          if n == "kernel.k5"]
    k6 = [p for n, p, _ in tree if n == "kernel.k6"]
    assert k6 == ["train.bwd"] * L
    bwd = [(n, a["layer"]) for n, p, a in tree
           if p == "train.bwd" and n.startswith("model.")]
    marked = sorted((n, p) for n, p, a in tree if a.get("recompute"))
    if remat == "none":
        assert marked == [] and bwd == []
        assert k5 == [("model.attn", False)] * L
    else:
        # the recompute runs the layers last to first, in the backward
        assert bwd == [(name, i) for i in reversed(range(L))
                       for name in ("model.attn", "model.mlp")]
        assert marked == sorted([("kernel.k5", "model.attn"),
                                 ("model.attn", "train.bwd"),
                                 ("model.mlp", "train.bwd")] * L)
        assert sorted(k5) == [("model.attn", False)] * L + [
            ("model.attn", True)] * L


def test_prefill_and_decode_span_trees():
    recs = _traced()
    (pre,) = _roots(recs, "serve.prefill")
    L = 2
    assert [(n, a.get("layer")) for n, p, a in _tree(_family(recs, pre))
            if p == "serve.prefill"] == [
        ("model.embed", None), ("model.cache", None)] + [
        (name, i) for i in range(L)
        for name in ("model.attn", "model.mlp", "model.cache")] + [
        ("model.head", None), ("serve.argmax", None)]
    assert [p for n, p, _ in _tree(_family(recs, pre))
            if n == "kernel.k5"] == ["model.attn"] * L
    decodes = _roots(recs, "serve.decode")
    assert len(decodes) == 2
    for d in decodes:
        tree = _tree(_family(recs, d))
        assert [(n, a.get("layer")) for n, p, a in tree
                if p == "serve.decode"] == [
            ("model.embed", None), ("decode.pos_read", None)] + [
            (name, i) for i in range(L)
            for name in ("model.attn", "model.mlp")] + [
            ("model.head", None), ("serve.argmax", None)]
        assert not any(n.startswith("kernel.") for n, _, _ in tree)


def test_host_syncs_count_the_decode_read_of_pos():
    recs = _traced("full")
    table = lm.span_table(recs)
    (step,) = _roots(recs, "train.step")
    (pre,) = _roots(recs, "serve.prefill")
    assert step["attrs"].get("host_syncs", 0) == 0
    assert pre["attrs"].get("host_syncs", 0) == 0
    for d in _roots(recs, "serve.decode"):
        assert d["attrs"]["host_syncs"] == 1
    assert table["decode.pos_read"] == {**table["decode.pos_read"],
                                        "calls": 2, "host_syncs": 2}
    assert sum(row["host_syncs"] for name, row in table.items()
               if "." in name and name != "decode.pos_read"
               and name != "serve.decode") == 0


def test_cast_bytes_of_a_prefill_are_the_parameters_converted():
    model = _model()
    params = model.init(torch.Generator().manual_seed(0))
    tokens = _batch(model.cfg)["tokens"]
    with lm.tracing("cpu") as tr:
        make_prefill_step(model, CAP)(params, {"tokens": tokens})
        recs = tr.records()
    (pre,) = _roots(recs, "serve.prefill")
    # every parameter but the norms' fp32 scales (taken as they are) and
    # the embedding table, of which the prompt's rows are converted
    table = params["embed.table"]
    want = sum(p.numel() * p.element_size() for n, p in params.items()
               if not n.endswith(".scale") and n != "embed.table")
    want += tokens.numel() * table.shape[1] * table.element_size()
    if model.cfg.tie_embeddings:
        want += table.numel() * table.element_size()
    assert pre["attrs"]["cast_bytes"] == want
    heads = [r for r in recs if r["name"] == "model.head"]
    unembed = params.get("embed.unembed", table)
    assert heads[0]["attrs"]["cast_bytes"] == \
        unembed.numel() * unembed.element_size()


def test_spans_are_in_the_profiler_trace_at_their_start():
    from torch.profiler import ProfilerActivity, profile
    model = _model()
    params = model.init(torch.Generator().manual_seed(0))
    tokens = _batch(model.cfg)["tokens"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with lm.tracing("cpu") as tr:
            tok, cache = make_prefill_step(model, CAP)(
                params, {"tokens": tokens})
            make_decode_step(model)(params, tok, cache)
            recs = tr.records()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    marks = {}
    for e in trace["traceEvents"]:
        if str(e.get("name", "")).startswith("repro:") \
                and e.get("ph") == "X":
            marks.setdefault(e["name"][len("repro:"):], []).append(
                float(e["ts"]) + base_us)
    spans = {}
    for r in recs:
        spans.setdefault(r["name"], []).append(r["t0"] * 1e6)
    assert spans.keys() == marks.keys()
    for name, starts in spans.items():
        assert len(starts) == len(marks[name]), name
        for ours, theirs in zip(sorted(starts), sorted(marks[name])):
            assert abs(ours - theirs) < 1000.0, name


def test_engine_tracer_keeps_its_stamps_and_adds_no_annotation():
    """A span of a tracer made without ``annotate`` (the streaming
    engine's) is stamped where it is made, not where it is entered, and
    opens no ``repro:`` region under the profiler; the LM tracer's does."""
    from torch.profiler import ProfilerActivity, profile
    engine = Tracer(sample_rate=1.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = engine.root("fold_round")
        t0 = span.t0
        with span:
            pass
        with lm.tracing("cpu"):
            with lm.span("model.head"):
                pass
    assert span.t0 == t0
    assert engine.records()[0]["t0"] == round(t0 / 1e9, 6)
    names = {e.key for e in prof.key_averages()}
    assert "repro:model.head" in names
    assert not any(n.startswith("repro:fold_round") for n in names)


@pytest.mark.parametrize("arch", [HYBRID, AUDIO])
def test_tracer_off_changes_nothing_in_the_other_families(arch):
    off = _run(_model(arch=arch))
    with lm.tracing("cpu"):
        on = _run(_model(arch=arch))
    assert off.keys() == on.keys()
    for name in off:
        assert torch.equal(off[name], on[name]), name


def test_hybrid_layers_time_attention_and_ssd_heads_apart():
    """hymba-1.5b's parallel heads: ``model.attn`` (the shared norm and
    attention) and then ``model.ssd`` (the SSD heads, the mean, the add),
    siblings under the step, so that attention's time holds no SSD."""
    recs = _traced(arch=HYBRID)
    mixer = ("model.attn", "model.ssd", "model.mlp")
    assert _under(recs, "train.step", "train.fwd") == [
        ("model.embed", None)] + _layers(mixer) + [("model.head", None)]
    assert _under(recs, "serve.prefill", "serve.prefill") == [
        ("model.embed", None), ("model.cache", None)] + _layers(
        mixer + ("model.cache",)) + [
        ("model.head", None), ("serve.argmax", None)]
    assert _under(recs, "serve.decode", "serve.decode") == [
        ("model.embed", None), ("decode.pos_read", None)] + _layers(
        mixer) + [("model.head", None), ("serve.argmax", None)]
    assert {p for n, p, _ in _tree(recs) if n == "kernel.k5"} == {
        "model.attn"}
    assert not any(p == "model.attn" for n, p, _ in _tree(recs)
                   if n.startswith("model."))


def test_encoder_and_cross_attention_spans():
    """seamless-m4t-medium: ``model.encoder`` holds the encoder's layers
    (bidirectional ``model.attn`` and ``model.mlp``); each decoder layer
    has ``model.xattn`` between its self-attention and its MLP, in the
    step, the prefill and the decode; K5 runs under both attentions."""
    recs = _traced(arch=AUDIO)
    dec = ("model.attn", "model.xattn", "model.mlp")
    enc = _layers(("model.attn", "model.mlp"))
    assert _under(recs, "train.step", "train.fwd") == [
        ("model.embed", None), ("model.encoder", None)] + _layers(dec) + [
        ("model.head", None)]
    assert _under(recs, "train.step", "model.encoder") == enc
    assert _under(recs, "serve.prefill", "serve.prefill") == [
        ("model.embed", None), ("model.encoder", None),
        ("model.cache", None)] + _layers(dec + ("model.cache",)) + [
        ("model.head", None), ("serve.argmax", None)]
    assert _under(recs, "serve.prefill", "model.encoder") == enc
    assert _under(recs, "serve.decode", "serve.decode") == [
        ("model.embed", None), ("decode.pos_read", None)] + _layers(dec) + [
        ("model.head", None), ("serve.argmax", None)]
    (pre,) = _roots(recs, "serve.prefill")
    assert sorted(p for n, p, _ in _tree(_family(recs, pre))
                  if n == "kernel.k5") == sorted(
        ["model.attn"] * 4 + ["model.xattn"] * 2)


def test_mesh_step_times_the_reduce_and_the_transform():
    """A train step as rank 0 of a (1, 2) mesh (a fake world: the
    collectives move nothing) with the int8 gradient transform:
    ``train.reduce`` and ``train.transform`` between the backward and
    AdamW."""
    mcfg = MeshConfig((1, 2), ("data", "model"))
    with dryrun.fake_world(mcfg.num_devices):
        mesh = dryrun.make_mesh_from_config(mcfg, "cpu")
        cell = dryrun.build_cell(
            reduced(get_config("starcoder2-7b")),
            ShapeConfig("train_4k", S, B, "train"), mcfg, mesh,
            {"compress_grads": True, "mu": 1, "remat": "none"})
        with shd.use_ctx(cell.ctx), lm.tracing("cpu") as tr:
            cell.run()
            recs = tr.records()
    assert _under(recs, "train.step", "train.step") == [
        ("train.fwd", None), ("train.bwd", None), ("train.reduce", None),
        ("train.transform", None), ("train.opt", None)]


@pytest.mark.gpu
def test_device_clock_times_the_spans_and_the_heads_backward():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device clock is CUDA events)")
    dev = torch.device("cuda")
    off = _run(_model("full", dev), dev)
    with lm.tracing(dev) as tr:
        on = _run(_model("full", dev), dev)
        torch.cuda.synchronize()
        recs = tr.records()
    for name in off:
        assert torch.equal(off[name], on[name]), name
    assert all(r["device_s"] > 0 for r in recs)
    (step,) = _roots(recs, "train.step")
    (head,) = [r for r in _family(recs, step) if r["name"] == "model.head"]
    assert head["device_bwd_s"] > 0
    bwd = [r for r in _family(recs, step) if r["name"] == "train.bwd"]
    assert head["device_bwd_s"] < bwd[0]["device_s"]
    table = lm.span_table(recs)
    assert table["kernel.k6"]["calls"] == 2
    assert table["model.attn (recompute)"]["calls"] == 2
