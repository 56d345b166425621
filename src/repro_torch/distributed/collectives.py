"""The LM mesh and its collectives, over ``torch.distributed``.

A ``Mesh`` is a logical device mesh (``MeshConfig``: axes and shape) laid
over the ranks of a process group, row-major (the last axis fastest, as
``jax.make_mesh`` lays out its devices): this rank's coordinates, one
process group per axis (the ranks that differ only along that axis), and
the ``torch.device`` the rank computes on. Every rank creates every
axis's groups in the same order, as ``torch.distributed.new_group``
requires. A mesh may cover a subset of the world's ranks (``ranks=``):
the elastic tests restore a (2, 2) state onto two of its four ranks. A
mesh of one rank needs no process group, and every collective on it is
the identity.

Every collective is built from ``all_reduce``, one of the two
collectives (with ``broadcast``) that PyTorch's backend table lists for
CUDA tensors under gloo; one card can host a world only through gloo
(NCCL refuses two ranks on one device):

- an all-gather is an ``all_reduce`` of a zeroed buffer that holds the
  rank's slice at its place;
- a reduce-scatter is an ``all_reduce`` followed by the rank's slice.

Each moves (n-1)/n more than the dedicated collective would. Low
precision floats are reduced in float32 (cast, reduce, cast back), so a
bf16 partial sum rounds once, as the one-device product does; an
all-gather's sum adds each element to zeros, exact in any type, so it
reduces in the tensor's own type (half the bytes of a bf16 weight's
float32 buffer).

Megatron's regions are ``torch.autograd.Function``s whose backward is the
dual collective:

- ``copy_to`` (Megatron's f): identity forward, ``all_reduce`` backward,
  in front of a column-parallel product;
- ``reduce_from`` (g): ``all_reduce`` forward, identity backward, behind
  a row-parallel product, and for statistics every rank adds to its loss
  (the MoE aux's means, the vocab-parallel softmax sums);
- ``gather`` (FSDP's use of a weight): all-gather forward, reduce-scatter
  backward;
- ``psum``: ``all_reduce`` both ways, for a sum that every rank then uses
  on data of its own (the SSD block's mean of squares over its heads).

``STATS`` counts each collective's calls, bytes (of the reduced buffer,
per rank) and host seconds, for ``chip_smoke.py`` phase 28.
"""
from __future__ import annotations

import itertools
import time
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig

Axes = Union[None, str, Sequence[str]]
#: per collective: calls, bytes, seconds (this process)
STATS: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})


def reset_stats() -> None:
    STATS.clear()


def choose_backend(device, world: int) -> Tuple[str, str]:
    """(backend, why): ``nccl`` when every rank has a card of its own
    (``cuda`` with no index and a card a rank: rank r on ``cuda:r``),
    ``gloo`` when ranks share one card or run on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", f"{world} rank(s) on the CPU"
    n = torch.cuda.device_count()
    if device.index is None and n >= world:
        return "nccl", f"{world} rank(s), one card each"
    return "gloo", (f"{world} ranks share {n} card(s) (NCCL refuses two "
                    "ranks on one device); every collective crosses the "
                    "host")


class Mesh:
    """A logical mesh over the ranks ``ranks`` (default: the whole world)
    of the default process group."""

    def __init__(self, cfg: MeshConfig, device,
                 ranks: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.axes = tuple(cfg.axes)
        self.shape = tuple(int(s) for s in cfg.shape)
        self.device = torch.device(device)
        initialized = dist.is_available() and dist.is_initialized()
        world_rank = dist.get_rank() if initialized else 0
        if ranks is None:
            ranks = range(dist.get_world_size() if initialized else 1)
        self.ranks = tuple(int(r) for r in ranks)
        if len(self.ranks) != cfg.num_devices:
            raise ValueError(f"mesh {self.shape} over {self.axes} needs "
                             f"{cfg.num_devices} ranks, given "
                             f"{len(self.ranks)}")
        self.member = world_rank in self.ranks
        self.rank = self.ranks.index(world_rank) if self.member else -1
        self.coords = _unravel(max(self.rank, 0), self.shape)
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for i, ax in enumerate(self.axes):
            self.groups[ax] = None
            if self.shape[i] == 1:
                continue
            others = [range(s) if j != i else [0]
                      for j, s in enumerate(self.shape)]
            for base in itertools.product(*others):
                members = []
                for k in range(self.shape[i]):
                    c = list(base)
                    c[i] = k
                    members.append(self.ranks[_ravel(c, self.shape)])
                group = dist.new_group(members)
                if world_rank in members:
                    self.groups[ax] = group

    @property
    def world(self) -> int:
        return len(self.ranks)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)] if axis in self.axes else 0

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axes, self.shape))}, rank {self.rank}"
                f" at {dict(zip(self.axes, self.coords))}, {self.device})")


def _unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], shape: Tuple[int, ...]) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _count(kind: str, t: torch.Tensor, t0: float) -> None:
    st = STATS[kind]
    st["calls"] += 1
    st["bytes"] += t.numel() * t.element_size()
    st["seconds"] += time.perf_counter() - t0


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes,
               op: str = "sum", kind: str = "all_reduce",
               exact: bool = False) -> torch.Tensor:
    """The sum (or ``max``, ``min``) of ``x`` over the mesh axes
    ``axes``, as a new tensor on every rank of each group; low precision
    floats reduce in float32, unless the caller knows the sum ``exact``
    in ``x``'s own type."""
    axes = [a for a in _axes(axes) if mesh.size(a) > 1]
    if not axes:
        return x.clone()
    upcast = not exact and x.is_floating_point() and x.element_size() < 4
    buf = x.float() if upcast else x
    buf = buf.clone().contiguous()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    for ax in axes:
        t0 = time.perf_counter()
        dist.all_reduce(buf, op=rop, group=mesh.groups[ax])
        _count(kind, buf, t0)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes,
               dim: int) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` over ``axes`` (a-major for axes
    (a, b)), concatenated: an ``all_reduce`` of a zeroed buffer holding
    this rank's slice."""
    for ax in reversed(_axes(axes)):
        n = mesh.size(ax)
        if n == 1:
            continue
        shape = list(x.shape)
        step = shape[dim]
        shape[dim] = step * n
        buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
        buf.narrow(dim, mesh.index(ax) * step, step).copy_(x)
        x = all_reduce(buf, mesh, ax, kind="all_gather", exact=True)
    return x


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: Axes,
                   dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, this rank's slice along ``dim``: an
    ``all_reduce``, then the slice."""
    for ax in _axes(axes):
        n = mesh.size(ax)
        if n == 1:
            continue
        x = all_reduce(x, mesh, ax, kind="reduce_scatter")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(ax) * step, step).contiguous()
    return x


# ------------------------------------------------------------- autograd
class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes, kind="copy_bwd"), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes, kind="reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


def _trivial(mesh: Optional[Mesh], axes: Axes) -> bool:
    return mesh is None or all(mesh.size(a) == 1 for a in _axes(axes))


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes
            ) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its gradient summed over ``axes``."""
    return x if _trivial(mesh, axes) else _Copy.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes
                ) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``axes``, its gradient as it is."""
    return x if _trivial(mesh, axes) else _Reduce.apply(x, mesh, axes)


def psum(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes
         ) -> torch.Tensor:
    """``x`` summed over ``axes``, its gradient summed over ``axes`` too
    (``reduce_from`` behind ``copy_to``)."""
    return copy_to(reduce_from(x, mesh, axes), mesh, axes)


def gather(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes,
           dim: int) -> torch.Tensor:
    """The full tensor from its shards along ``dim``; the gradient is
    reduce-scattered back to this rank's shard."""
    return x if _trivial(mesh, axes) else _Gather.apply(x, mesh, axes, dim)
