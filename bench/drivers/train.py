"""The training driver: the port's ``make_train_step`` over the model of
the configuration, fed packed rows of tokens drawn uniformly from the
seed on the device.

Set-up draws the weights from the seed, builds one train state and drives
it through the first ``checked_steps`` steps through the window's own
call and feed (the first compiles and warms up): their losses, the first
gradient as AdamW took it (its first moment over ``1 - beta1``) and each
leaf's change after them are kept. The same state then runs the window:
steps until ``seconds`` have passed, each ended by a synchronise. After
it, the program's state is freed and the plain reference follows the
first steps from its own copy of the weights on the same rows.

A traced run times the forward, backward and optimizer of every window
step, and the K5 and K6 entry points, on CUDA events, then profiles two
more steps.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from bench import compare, counts, program, weights
from bench.harness import Clock, Probe, profile_segment, span
from bench.reference import common as ref
from bench.reference import family


def traffic_seed(seed: int) -> int:
    return (int(seed) * 2_654_435_761 + 29) % (1 << 62)


class Feed:
    """Rows of ``seq_len + 1`` tokens uniform over the vocabulary, drawn
    on the device: the inputs and their next-token targets."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(traffic_seed(seed))
        self.shape = (traffic["batch"], traffic["seq_len"] + 1)
        self.vocab = cfg["vocab_size"]
        self.device = device

    def __call__(self) -> dict:
        rows = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device, dtype=torch.int32)
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


def leaf_norms(tensors: dict) -> dict:
    return {n: float(v) for n, v in zip(
        tensors, torch.stack([t.detach().float().norm()
                              for t in tensors.values()]).tolist())}


def change_norms(cfg: dict, seed: int, params: dict, device) -> dict:
    """Each leaf's norm of its change from the seed's draw."""
    out = {}
    with torch.no_grad():
        for group in weights.groups_of(cfg, seed, device):
            for n, p0 in group.items():
                out[n] = float((params[n].detach() - p0).norm())
    return out


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_steps(cfg: dict, traffic: dict, seed: int, batches: list,
                    device, precision: str = "fp32") -> dict:
    """The plain reference's first steps on the same rows from its own
    draw of the weights: the losses, the first clipped gradient's leaf
    norms, and each leaf's change after the steps."""
    ref.plain_settings()
    layer = family(cfg).layer
    rnd = ref.Precision(precision)
    params = weights.make(cfg, seed, device, requires_grad=True)
    opt = ref.AdamW(traffic["opt"], params)
    losses, grad = [], None
    for batch in batches:
        loss, grads = ref.loss_and_grads(cfg, params, batch, layer, rnd)
        clipped = opt.step(params, grads)
        if grad is None:
            grad = leaf_norms(clipped)
        losses.append(loss)
        del grads, clipped
    change = change_norms(cfg, seed, params, device)
    del params, opt
    free()
    return {"losses": losses, "grad": grad, "change": change}


def program_first_steps(cfg: dict, traffic: dict, seed: int, device):
    """Set-up: the weights, the one train state, its step and feed, and
    the first steps' readings. Returns (model, state, step, feed, the
    readings, the rows of the first steps)."""
    model = program.build_model(cfg, device)
    params = weights.make(cfg, seed, device, requires_grad=True)
    state = program.train_state(params)
    step = program.train_step(model, traffic["opt"])
    feed = Feed(cfg, traffic, seed, device)
    losses, batches, grad = [], [], None
    b1 = traffic["opt"]["beta1"]
    for i in range(traffic["checked_steps"]):
        batch = feed()
        batches.append({k: v.clone() for k, v in batch.items()})
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        if i == 0:
            grad = {n: g / (1.0 - b1) for n, g in
                    leaf_norms(program.first_moments(state)).items()}
    readings = {"losses": [float(x) for x in losses], "grad": grad,
                "change": change_norms(cfg, seed, state.params, device)}
    return model, state, step, feed, readings, batches


def run(ctx: dict) -> dict:
    cfg, traffic = ctx["config"]["model"], ctx["traffic"]
    seed, dev = ctx["seed"], torch.device(ctx["device"])
    clock = Clock(dev)
    model, state, step, feed, prog, batches = program_first_steps(
        cfg, traffic, seed, dev)
    clock.sync()
    tokens_per_step = traffic["batch"] * traffic["seq_len"]
    peak_setup = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
        else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    probe = Probe(clock, program.train_targets(model)) if ctx["trace"] \
        else None
    steps, losses, marks = 0, [], []

    def one_step():
        nonlocal state
        with span("feed"):
            batch = feed()
        start = clock.stamp()
        with span("step"):
            state, metrics = step(state, batch)
        marks.append((start, clock.stamp()))
        losses.append(metrics["loss"])
        with span("sync"):
            clock.sync()

    t_setup = time.perf_counter()
    setup_s = t_setup - ctx["t0"]
    if probe is not None:
        probe.__enter__()
    try:
        ends = []
        while True:
            one_step()
            steps += 1
            ends.append(time.perf_counter() - t_setup)
            if ends[-1] >= ctx["seconds"]:
                break
        window_s = time.perf_counter() - t_setup
        record = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
                  "tokens": steps * tokens_per_step, "steps": steps,
                  "step_ends_s": ends}
        if dev.type == "cuda":
            record["peak_bytes"] = torch.cuda.max_memory_allocated()
        profile = None
        if probe is not None:
            record.update(traced_train(cfg, traffic, probe, clock, marks,
                                       steps))
            marks.clear()
            profile = profile_segment(lambda: [one_step() for _ in range(2)],
                                      dev)
            record["idle_share"] = 100.0 * (1 - profile["busy_s"]
                                            / profile["window_s"])
    finally:
        if probe is not None:
            probe.__exit__(None, None, None)
    losses = [float(x) for x in losses]
    failed = sum(not math.isfinite(x) for x in losses[:steps])
    peak = max(peak_setup, record.get("peak_bytes", 0))
    del model, state, step, feed, probe
    free()
    t_ref = time.perf_counter()
    ref_read = reference_steps(cfg, traffic, seed, batches, dev)
    readings = compare.train_readings(prog, ref_read)
    checks = compare.held(readings, traffic["limits"])
    return {"record": record, "attempted": steps, "failed": failed,
            "memory_peak_bytes": peak, "profile": profile,
            "checks": checks, "where": readings["where"],
            "phases": {"setup_s": setup_s, "window_s": window_s,
                       "step_s": _spread(record["step_ends_s"]),
                       "reference_s": time.perf_counter() - t_ref},
            "correct": failed == 0 and compare.all_within(checks)}


def _spread(ends: list) -> list:
    """The shortest, median and longest step of the window (host clock)."""
    steps = sorted(b - a for a, b in zip([0.0] + ends, ends))
    return [steps[0], steps[len(steps) // 2], steps[-1]]


def traced_train(cfg: dict, traffic: dict, probe: Probe, clock: Clock,
                 marks: list, steps: int) -> dict:
    """The per-step device times of a traced window and the needed work
    of the timed ops."""
    clock.sync()
    loss, adam = probe.stamps["loss"], probe.stamps["adamw"]
    fwd = sum(clock.seconds(a, b) for a, b in loss)
    opt = sum(clock.seconds(a, b) for a, b in adam)
    bwd = sum(clock.seconds(l[1], a[0]) for l, a in zip(loss, adam))
    step_s = sum(clock.seconds(a, b) for a, b in marks)
    b, s = traffic["batch"], traffic["seq_len"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    d, L = weights.head_dim(cfg), cfg["num_layers"]
    w = cfg.get("attn_window", 0)
    k5 = counts.flash_fwd(b, s, h, hkv, d, causal=True, window=w, lse=True)
    k6 = counts.flash_bwd(b, s, h, hkv, d, causal=True, window=w)
    return {"steps_timed": steps, "fwd_s": fwd, "bwd_s": bwd, "opt_s": opt,
            "step_device_s": step_s,
            "k5": {"need_s": steps * L * counts.least_seconds(
                k5["flops"], k5["bytes"]), "time_s": probe.seconds("k5"),
                "calls": probe.calls("k5")},
            "k6": {"need_s": steps * L * counts.least_seconds(
                k6["flops"], k6["bytes"]), "time_s": probe.seconds("k6"),
                "calls": probe.calls("k6")},
            "model_flops": steps * b * counts.train_flops(cfg, s)}
