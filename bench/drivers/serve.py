"""The serving driver: the port's model-level serving loop
(``make_prefill_step``, then ``make_decode_step`` greedily, as
``launch/serve.py`` runs it) driven by a closed loop of clients.

The traffic file gives the lengths as distributions: a request's prompt
and its output are lognormal (``median``, ``sigma``) as a published
characterisation reports them, cut to the cell's ``positions``. The
port serves a batch whose prompts share one length, so the requests come
in batches of ``batch`` (the clients) of one prompt length each, as a
server that groups its queue by length sends them. A cycle is
``batches_per_cycle`` batches whose prompt lengths are that many middle
quantiles of the prompt's distribution (rounded to ``multiple``); every
batch's requests take the ``batch`` middle quantiles of the output's
distribution. So every seed serves the same lengths: the seed draws the
order of the batches, which request gets which output, and every
prompt's tokens (uniform, on the device). A batch decodes until its
longest output is served; a request's tokens are its own output's.

A client's next request goes out when its batch starts, which is when
the last one has finished. The window is whole cycles: the first cycle
that ends at or after ``seconds`` closes it, so every run serves the same
mix. Each request is timed from its batch's start to its first token on
the host (the prefill and the argmax read back).

Set-up draws the weights and warms up each prompt length of the cycle
(its prefill at the window's batch and cache size, and two decode
steps). After the window, the program's state is freed, a sample of the
finished requests drawn from the seed (the longest request among them)
is run through the plain reference over each prompt and its served
tokens, and the widest gap by which a served token's logit lies below
the reference's best is compared. A traced run times K5's entry point in
every prefill on CUDA events, then profiles one more batch, at the
cycle's middle prompt length (a whole cycle's trace would not be read
within a run's time).
"""
from __future__ import annotations

import math
import statistics
import time
from typing import List, Tuple

import torch

from bench import compare, counts, program, weights
from bench.drivers.train import free
from bench.harness import Clock, Probe, profile_segment, span
from bench.reference import common as ref
from bench.reference import family


def traffic_seed(seed: int, k: int) -> int:
    return (int(seed) * 6_364_136_223 + 101 * k + 7) % (1 << 62)


def quantiles(dist: dict, n: int) -> List[float]:
    """The ``n`` middle quantiles, ``(i + 1/2) / n``, of the lognormal
    ``dist`` (``median``, ``sigma``; ``sigma`` 0 is one length)."""
    z = statistics.NormalDist()
    return [dist["median"] * math.exp(dist["sigma"] * z.inv_cdf(
        (i + 0.5) / n)) for i in range(n)]


def mix(traffic: dict) -> Tuple[List[int], List[int]]:
    """(a cycle's prompt lengths, one a batch; a batch's output lengths,
    one a request), as every seed serves them."""
    outputs = [max(1, round(x)) for x in quantiles(traffic["output"],
                                                   traffic["batch"])]
    step = traffic["prompt"]["multiple"]
    most = (traffic["positions"] - max(outputs)) // step * step
    prompts = [min(most, max(step, round(x / step) * step))
               for x in quantiles(traffic["prompt"],
                                  traffic["batches_per_cycle"])]
    return prompts, outputs


class Clients:
    """The closed loop's batches: each cycle's order and each request's
    output drawn on the host, the prompts' tokens on the device."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.order = torch.Generator().manual_seed(traffic_seed(seed, 1))
        self.tokens = torch.Generator(device=device)
        self.tokens.manual_seed(traffic_seed(seed, 2))
        self.lengths, self.outputs = mix(traffic)
        self.capacity = max(self.outputs)
        self.batch, self.vocab, self.device = (traffic["batch"],
                                               cfg["vocab_size"], device)

    def next_cycle(self) -> List[Tuple[int, List[int]]]:
        """(prompt length, each request's output length) a batch."""
        out = []
        for i in torch.randperm(len(self.lengths),
                                generator=self.order).tolist():
            rows = torch.randperm(self.batch, generator=self.order).tolist()
            out.append((self.lengths[i], [self.outputs[r] for r in rows]))
        return out

    def middle(self) -> Tuple[int, List[int]]:
        """A batch at the cycle's middle prompt length (the upper of two),
        its outputs in a drawn order."""
        rows = torch.randperm(self.batch, generator=self.order).tolist()
        return (sorted(self.lengths)[len(self.lengths) // 2],
                [self.outputs[r] for r in rows])

    def prompts(self, length: int) -> torch.Tensor:
        return torch.randint(0, self.vocab, (self.batch, length),
                             generator=self.tokens, device=self.device,
                             dtype=torch.int32)


def serve_batch(model, params, decode, prompts: torch.Tensor,
                outputs: List[int], capacity: int) -> dict:
    """One batch through the loop: prefill into a cache of ``length +
    capacity`` positions, then greedy decode steps until the longest of
    ``outputs`` is served, each step's tokens read back to the host."""
    b, length = prompts.shape
    prefill = program.prefill_step(model, length + capacity)
    t0 = time.perf_counter()
    with span("prefill"):
        tok, cache = prefill(params, {"tokens": prompts})
    with span("read"):
        out = [tok.cpu()]
    ttft = time.perf_counter() - t0
    for _ in range(max(outputs) - 1):
        with span("decode"):
            tok, cache = decode(params, tok, cache)
        with span("read"):
            out.append(tok.cpu())
    del cache
    return {"ttft": ttft, "served": torch.cat(out, dim=1), "length": length,
            "outputs": list(outputs)}


def serve_cycle(model, params, decode, clients: Clients,
                plan=None) -> list:
    """One cycle of the closed loop (or the batches of ``plan``); each
    batch keeps its prompts."""
    batches = []
    for length, outputs in plan or clients.next_cycle():
        with span("arrivals"):
            prompts = clients.prompts(length)
        bt = serve_batch(model, params, decode, prompts, outputs,
                         clients.capacity)
        bt["prompts"] = prompts
        batches.append(bt)
    return batches


def warm_up(model, params, decode, clients: Clients, seed: int) -> None:
    """Each prompt length of the cycle at the window's batch and cache
    size: its prefill and two decode steps."""
    gen = torch.Generator(device=clients.device)
    gen.manual_seed(traffic_seed(seed, 4))
    for length in sorted(set(clients.lengths)):
        serve_batch(model, params, decode, torch.randint(
            0, clients.vocab, (clients.batch, length), generator=gen,
            device=clients.device, dtype=torch.int32),
            [3] * clients.batch, clients.capacity)


def requests(batches: list) -> list:
    """Every finished request as (batch, row)."""
    return [(i, r) for i, bt in enumerate(batches)
            for r in range(bt["served"].shape[0])]


def served(bt: dict, r: int) -> torch.Tensor:
    """Request ``r``'s own served tokens."""
    return bt["served"][r, :bt["outputs"][r]]


def sample(batches: list, k: int, seed: int) -> list:
    """``k`` finished requests, (batch, row): the longest (prompt and
    output; the first of equals) and ``k - 1`` others drawn from the
    seed."""
    gen = torch.Generator().manual_seed(traffic_seed(seed, 3))
    every = requests(batches)
    size = [batches[i]["length"] + batches[i]["outputs"][r]
            for i, r in every]
    longest = size.index(max(size))
    rest = [x for j, x in enumerate(every) if j != longest]
    pick = [rest[j] for j in torch.randperm(len(rest),
                                            generator=gen)[:k - 1].tolist()]
    return [every[longest]] + pick


def reference_gaps(cfg: dict, seed: int, batches: list, picks: list,
                   device, judge: str = "") -> dict:
    """The reference over each picked request's prompt and served tokens:
    every served token's gap below the best logit at its position, and
    with ``judge`` (a lower precision: the control) the gaps of the
    tokens that precision puts first."""
    ref.plain_settings()
    layer = family(cfg).layer
    params = weights.make(cfg, seed, device)
    rnd = ref.Precision("fp32")
    low = ref.Precision(judge) if judge else None
    gaps, cgaps = [], []
    for i, r in picks:
        bt = batches[i]
        g, _, cg = ref.served_gaps(cfg, params, bt["prompts"][r],
                                   served(bt, r).to(device), layer, rnd,
                                   low)
        gaps.append(g)
        if cg is not None:
            cgaps.append(cg)
    del params
    free()
    out = {"gap": float(torch.cat(gaps).max()),
           "tokens": int(sum(g.numel() for g in gaps))}
    if cgaps:
        out["control_gap"] = float(torch.cat(cgaps).max())
    return out


def run(ctx: dict) -> dict:
    cfg, traffic = ctx["config"]["model"], ctx["traffic"]
    seed, dev = ctx["seed"], torch.device(ctx["device"])
    clock = Clock(dev)
    model = program.build_model(cfg, dev)
    with torch.no_grad():
        params = weights.make(cfg, seed, dev)
    decode = program.decode_step(model)
    clients = Clients(cfg, traffic, seed, dev)
    warm_up(model, params, decode, clients, seed)
    clock.sync()
    peak_setup = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
        else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    probe = Probe(clock, program.serve_targets(model)) if ctx["trace"] \
        else None
    batches: list = []

    t_setup = time.perf_counter()
    setup_s = t_setup - ctx["t0"]
    if probe is not None:
        probe.__enter__()
    try:
        while True:
            batches += serve_cycle(model, params, decode, clients)
            if time.perf_counter() - t_setup >= ctx["seconds"]:
                break
        window_s = time.perf_counter() - t_setup
        record = window_record(cfg, batches, setup_s, window_s)
        if dev.type == "cuda":
            record["peak_bytes"] = torch.cuda.max_memory_allocated()
        profile = None
        if probe is not None:
            clock.sync()
            record.update(traced_serve(cfg, batches, probe))
            profile = profile_segment(lambda: serve_cycle(
                model, params, decode, clients, [clients.middle()]), dev)
    finally:
        if probe is not None:
            probe.__exit__(None, None, None)
    every = requests(batches)
    failed = sum(bool(((served(batches[i], r) < 0)
                       | (served(batches[i], r) >= cfg["vocab_size"])).any())
                 for i, r in every)
    peak = max(peak_setup, record.get("peak_bytes", 0))
    del model, params, decode, probe
    free()
    t_ref = time.perf_counter()
    picks = sample(batches, traffic["check_requests"], seed)
    readings = reference_gaps(cfg, seed, batches, picks, dev)
    checks = compare.held(readings, traffic["limits"])
    return {"record": record, "attempted": len(every), "failed": failed,
            "memory_peak_bytes": peak, "profile": profile,
            "checks": checks, "where": {"tokens_compared":
                                        readings["tokens"]},
            "phases": {"setup_s": setup_s, "window_s": window_s,
                       "reference_s": time.perf_counter() - t_ref},
            "correct": failed == 0 and compare.all_within(checks)}


def window_record(cfg: dict, batches: list, setup_s: float,
                  window_s: float) -> dict:
    """Each request's wait for its first token, and the prefills' model
    FLOPs and time."""
    ttft, pre_flops = [], 0.0
    for bt in batches:
        ttft += [bt["ttft"]] * len(bt["outputs"])
        pre_flops += len(bt["outputs"]) * counts.prefill_flops(
            cfg, bt["length"])
    return {"kind": "serve", "setup_s": setup_s, "window_s": window_s,
            "ttft_s": ttft, "prefill_flops": pre_flops,
            "prefill_s": sum(bt["ttft"] for bt in batches)}


def traced_serve(cfg: dict, batches: list, probe: Probe) -> dict:
    """The needed work of each prefill's K5 launches beside their
    measured time."""
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    d, L = weights.head_dim(cfg), cfg["num_layers"]
    w = cfg.get("attn_window", 0)
    k5 = 0.0
    for bt in batches:
        b, s = bt["served"].shape[0], bt["length"]
        c = counts.flash_fwd(b, s, h, hkv, d, causal=True, window=w,
                             lse=False)
        k5 += L * counts.least_seconds(c["flops"], c["bytes"])
    return {"k5": {"need_s": k5, "time_s": probe.seconds("k5"),
                   "calls": probe.calls("k5")}}
