"""The plain reference's shared parts, in float32 plain PyTorch: norms,
rotary embeddings, blocked causal attention, the model's loop, its loss
and AdamW. It imports nothing of the program and nothing of JAX; the
family modules (``dense.py``) give each layer.

The mathematics is the one the port's configuration states, written from
the published descriptions: RMSNorm (mean of squares, a scale), RoPE in
split-halves form over positions from 0, grouped-query attention (query
head ``i`` reads key head ``i // (heads / kv_heads)``) scaled by
``1 / sqrt(head_dim)``, causal and, where a window ``w`` is set, key
``j`` seen from query ``i`` only while ``i - j < w``; an untied
unembedding over the real vocabulary, cross-entropy averaged over every
target.

``Precision`` is where the arithmetic can be lowered for the control:
float32 (the reference) or every product's inputs rounded to fp8 e4m3
with a per-tensor scale, the step below the bf16 compute the
configuration states (a straight-through rounding, so that the control
trains too).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def plain_settings() -> None:
    """Full float32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The rounding of every product's inputs: ``"fp32"`` none, ``"fp8"``
    to e4m3 with a per-tensor scale (amax to 448)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x).detach()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [b, s, h, d] rotated at ``positions`` [s], split halves."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]            # [s, d/2]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], rnd: Precision,
           contract: int = 1) -> torch.Tensor:
    """x [..., in] times w [in, *out] (``contract`` trailing dims of x
    against the leading dims of w), plus the bias where there is one."""
    y = torch.tensordot(rnd(x), rnd(p["w"]), dims=contract)
    if "b" in p:
        y = y + p["b"]
    return y


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, rnd: Precision, block: int = 1024
              ) -> torch.Tensor:
    """Causal grouped-query attention, q [b, s, h, d], k/v [b, s, hkv, d]
    -> [b, s, h, d], a block of queries at a time against only the keys
    it can see."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hkv, g, d)
    outs = []
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        k0 = 0 if window <= 0 else max(0, q0 - window + 1)
        qb = rnd(qg[:, q0:q1])
        kb, vb = rnd(k[:, k0:q1]), rnd(v[:, k0:q1])
        scores = torch.einsum("bqkgd,bjkd->bkgqj", qb, kb) * scale
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        keep = kj <= qi
        if window > 0:
            keep = keep & (qi - kj < window)
        scores = scores.masked_fill(~keep, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgqj,bjkd->bqkgd", rnd(p), vb))
    return torch.cat(outs, dim=1).reshape(b, s, h, d)


def split_tree(params: Dict[str, torch.Tensor]) -> dict:
    """Named leaves (``layers.3.attn.q.w``) as a nested tree, the layers a
    list."""
    tree: dict = {"layers": {}}
    for name, t in params.items():
        parts = name.split(".")
        if parts[0] == "layers":
            node = tree["layers"].setdefault(int(parts[1]), {})
            parts = parts[2:]
        else:
            node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    tree["layers"] = [tree["layers"][i] for i in sorted(tree["layers"])]
    return tree


def hidden(cfg: dict, tree: dict, tokens: torch.Tensor,
           layer: Callable, rnd: Precision, remat: bool) -> torch.Tensor:
    """The final norm's output [b, s, d] for ``tokens`` [b, s]."""
    x = tree["embed"]["table"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in tree["layers"]:
        if remat:
            x = checkpoint(layer, cfg, lp, x, positions, rnd,
                           use_reentrant=False)
        else:
            x = layer(cfg, lp, x, positions, rnd)
    return rmsnorm(x, tree["final_norm"]["scale"], cfg["norm_eps"])


def logits_at(cfg: dict, tree: dict, x: torch.Tensor, rnd: Precision
              ) -> torch.Tensor:
    """Logits over the real vocabulary for the hidden states ``x``."""
    w = tree["embed"]["unembed"][:, :cfg["vocab_size"]]
    return torch.matmul(rnd(x), rnd(w))


def loss_and_grads(cfg: dict, params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], layer: Callable,
                   rnd: Precision):
    """The mean cross-entropy over every target of ``batch`` and each
    parameter's gradient, a row of the batch at a time (the sums of each
    row's cross-entropy over the whole count), every layer recomputed in
    the backward to fit. Returns (loss, grads by name)."""
    tree = split_tree(params)
    tokens, targets = batch["tokens"], batch["targets"].long()
    ntok = float((targets >= 0).sum())
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    names = list(params)
    total = 0.0
    for r in range(tokens.shape[0]):
        x = hidden(cfg, tree, tokens[r:r + 1], layer, rnd, remat=True)
        logits = logits_at(cfg, tree, x, rnd)
        tgt = targets[r:r + 1]
        mask = (tgt >= 0).float()
        ce = (torch.logsumexp(logits, -1)
              - torch.gather(logits, -1, tgt.clamp(min=0)[..., None])[..., 0])
        row = (ce * mask).sum() / ntok
        gs = torch.autograd.grad(row, [params[n] for n in names],
                                 allow_unused=True)
        for n, g in zip(names, gs):
            if g is not None:
                grads[n] += g
        total += float(row.detach())
        del x, logits, ce, row, gs
    return total, grads


class AdamW:
    """AdamW as the configuration's optimizer states it: the gradient
    clipped by the global norm of all of them, moments in float32, bias
    correction, a linear warm-up then a cosine to ``min_lr_frac``, and
    decoupled weight decay on every leaf a layer holds and every matrix
    (the layers' leaves are one stacked tensor each in the source's tree,
    so even their vectors are matrices there)."""

    def __init__(self, opt: dict, params: Dict[str, torch.Tensor]):
        self.o = opt
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    def lr(self, t: int) -> float:
        o = self.o
        if t < o["warmup_steps"]:
            return o["lr"] * t / max(o["warmup_steps"], 1)
        prog = (t - o["warmup_steps"]) / max(o["total_steps"]
                                             - o["warmup_steps"], 1)
        prog = min(max(prog, 0.0), 1.0)
        return o["lr"] * (o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5
                          * (1 + math.cos(math.pi * prog)))

    @staticmethod
    def decays(name: str, p: torch.Tensor) -> bool:
        return p.dim() + (1 if name.startswith("layers.") else 0) >= 2

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step in place; returns the gradients as clipped."""
        o = self.o
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        scale = min(o["clip_norm"] / max(gnorm, 1e-9), 1.0)
        self.t += 1
        lr = self.lr(self.t)
        bc1 = 1 - o["beta1"] ** self.t
        bc2 = 1 - o["beta2"] ** self.t
        clipped = {}
        for n, p in params.items():
            g = grads[n] * scale
            clipped[n] = g
            self.m[n].mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
            self.v[n].mul_(o["beta2"]).add_(g.square(), alpha=1 - o["beta2"])
            delta = (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + o["eps"])
            if self.decays(n, p):
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
        return clipped


def served_gaps(cfg: dict, params: Dict[str, torch.Tensor],
                prompt: torch.Tensor, served: torch.Tensor, layer: Callable,
                rnd: Precision, judge: Optional[Precision] = None):
    """For one request: the reference's logits at each position that
    produced a served token (the prompt's last, then each served token's
    but the last), over the prompt and the served tokens. Returns (the
    gap of each served token below the best logit there, the tokens that
    ``judge``'s precision puts first at those positions, their gaps), the
    last two None without ``judge``."""
    tree = split_tree(params)
    seq = torch.cat([prompt, served[:-1]])[None]
    at = torch.arange(prompt.numel() - 1, seq.shape[1], device=seq.device)
    with torch.no_grad():
        x = hidden(cfg, tree, seq, layer, rnd, remat=False)[0, at]
        logits = logits_at(cfg, tree, x, rnd)
        best = logits.max(-1).values
        gaps = best - logits.gather(-1, served.long()[:, None])[:, 0]
        if judge is None:
            return gaps, None, None
        xj = hidden(cfg, tree, seq, layer, judge, remat=False)[0, at]
        picks = logits_at(cfg, tree, xj, judge).argmax(-1)
        pgaps = best - logits.gather(-1, picks[:, None])[:, 0]
        return gaps, picks, pgaps
