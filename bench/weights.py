"""Weights made from the seed, the same tensors for the program and for
the reference.

``layout(cfg)`` names every parameter as the port's model takes it (the
JAX package's tree: ``layers.3.attn.q.w`` [d, heads, head_dim]) with its
shape and how it is drawn; ``make(cfg, seed, device)`` draws them on the
device: one ``randn`` call for the embeddings and one a layer, each leaf
a slice of its call's values, scaled (fan-in normal for a projection,
small for a bias, near 1 for a norm's scale) or mapped by a rule of the
layer's family. A layer's leaves are its family's
(``bench/reference/<family>.py``). The same seed on the same device gives
the same bits, so the reference draws its own copy after the program's
state is freed and takes nothing the program made.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.reference import family

PAD = 256       # the vocabulary rows the port's embedding pads to


def padded_vocab(v: int) -> int:
    return (v + PAD - 1) // PAD * PAD


def head_dim(cfg: dict) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]


# (name, shape, rule): rule is ("normal", std) | ("one", std) | (a name in
# the family's ``RULES``,)
Leaf = Tuple[str, Tuple[int, ...], tuple]


def projection(name: str, ins: tuple, outs: tuple,
               bias: bool) -> List[Leaf]:
    """A product's weight ``w`` [*ins, *outs], fan-in normal, and its small
    bias [*outs] where the configuration keeps one."""
    out = [(f"{name}.w", (*ins, *outs),
            ("normal", 1.0 / math.sqrt(math.prod(ins))))]
    if bias:
        out.append((f"{name}.b", tuple(outs), ("normal", 0.02)))
    return out


def layout(cfg: dict) -> List[List[Leaf]]:
    """Groups of leaves, one ``randn`` call each: the embeddings and the
    final norm first, then each layer as its family's reference lays it
    out, named as the port's model names them."""
    d, vp = cfg["d_model"], padded_vocab(cfg["vocab_size"])
    layer = family(cfg).leaves(cfg)
    head = [("embed.table", (vp, d), ("normal", 1.0)),
            ("embed.unembed", (d, vp), ("normal", 1.0 / math.sqrt(d))),
            ("final_norm.scale", (d,), ("one", 0.05))]
    groups = [head]
    for i in range(cfg["num_layers"]):
        groups.append([(f"layers.{i}.{n}", s, r) for n, s, r in layer])
    return groups


def _fill(z: torch.Tensor, rule: tuple, rules: dict) -> torch.Tensor:
    """A leaf from standard normal draws ``z`` by its rule: ``normal``
    (scaled), ``one`` (1 plus scaled), or one of the family's ``rules``."""
    kind = rule[0]
    if kind == "normal":
        return z * rule[1]
    if kind == "one":
        return 1.0 + z * rule[1]
    if kind in rules:
        return rules[kind](z)
    raise ValueError(f"unknown rule {rule!r}")


def weight_seed(seed: int) -> int:
    return (int(seed) * 1_000_003 + 17) % (1 << 62)


def make_group(group: List[Leaf], gen: torch.Generator, device,
               out: Dict[str, torch.Tensor], rules: dict) -> None:
    """Draw one group with one ``randn`` call into ``out``, each leaf its
    own float32 tensor."""
    total = sum(math.prod(s) for _, s, _ in group)
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    at = 0
    for name, shape, rule in group:
        n = math.prod(shape)
        # every rule computes a new tensor: no leaf is a view of ``flat``
        out[name] = _fill(flat[at:at + n].view(shape), rule, rules)
        at += n
    del flat


def make(cfg: dict, seed: int, device,
         requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    """Every parameter of ``cfg`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weight_seed(seed))
    out: Dict[str, torch.Tensor] = {}
    rules = getattr(family(cfg), "RULES", {})
    for group in layout(cfg):
        make_group(group, gen, device, out, rules)
    if requires_grad:
        for t in out.values():
            t.requires_grad_(True)
    return out


def groups_of(cfg: dict, seed: int, device):
    """Yield each group's leaves as drawn, one group at a time, from the
    same draws as ``make``: for reading a leaf's starting value without
    holding every one."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weight_seed(seed))
    rules = getattr(family(cfg), "RULES", {})
    for group in layout(cfg):
        out: Dict[str, torch.Tensor] = {}
        make_group(group, gen, device, out, rules)
        yield out
