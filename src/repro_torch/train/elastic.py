"""Elastic scaling: reshard a train state onto a different mesh.

A checkpoint is mesh-agnostic (full arrays + manifest,
``train/checkpoint.py``); growing or shrinking the fleet is
restore-with-new-shardings. ``elastic_reshard`` also moves a live state:
gathered from the mesh it is sharded on (a collective over that mesh's
ranks), then re-placed onto the new one, whose ranks each keep their
shard. ``adjust_batch_schedule`` keeps the global batch contract when the
data-parallel degree changes.

A placement is the port's ``NamedSharding``: a mesh and a pspec
(``distributed/sharding.py``), whose ``local`` is this rank's piece of a
full tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import Model
from repro_torch.train.train_step import TrainState, make_train_state_specs


@dataclass(frozen=True)
class Placement:
    """A tensor's layout on a mesh: one mesh axis (or axes, or None) a
    dim."""
    mesh: Any
    pspec: Tuple[Any, ...]

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``, on the mesh's device."""
        sl = shd.shard_slices(full.shape, self.pspec, self.mesh)
        return full[sl].to(self.mesh.device).contiguous()

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (a collective over the
        mesh's ranks)."""
        for dim, entry in enumerate(self.pspec):
            shard = col.all_gather(shard, self.mesh, shd.entry_axes(entry),
                                   dim)
        return shard


def state_shardings(model: Model, mesh, mesh_cfg: MeshConfig,
                    global_batch: int) -> TrainState:
    """The placement of every leaf of a train state: ``make_rules`` over
    ``make_train_state_specs``."""
    return placements(model, mesh,
                      shd.make_rules(model.cfg, mesh_cfg, global_batch))


def placements(model: Model, mesh, rules: Dict[str, Any]) -> TrainState:
    """The placement of every leaf of a train state under ``rules``."""
    logical = make_train_state_specs(model)

    def place(specs: Dict[str, tuple]) -> Dict[str, Placement]:
        return {n: Placement(mesh, shd.logical_to_pspec(s, rules))
                for n, s in specs.items()}

    return TrainState(params=place(logical.params),
                      opt={"m": place(logical.opt["m"]),
                           "v": place(logical.opt["v"]),
                           "step": Placement(mesh, ())})


def _map(state: TrainState, places: TrainState, fn) -> TrainState:
    params = {n: fn(t, places.params[n]) for n, t in state.params.items()}
    opt = {k: {n: fn(t, places.opt[k][n]) for n, t in state.opt[k].items()}
           for k in ("m", "v")}
    opt["step"] = fn(state.opt["step"], places.opt["step"])
    return TrainState(params=params, opt=opt)


def gather_state(state: TrainState, model: Model, mesh,
                 rules: Dict[str, Any]) -> TrainState:
    """The full arrays of a state sharded on ``mesh`` under ``rules``, on
    the host (every rank of the mesh calls it)."""
    places = placements(model, mesh, rules)
    return _map(state, places,
                lambda t, p: p.gather(t.detach()).cpu())


def elastic_reshard(state: TrainState, model: Model, new_mesh,
                    new_mesh_cfg: MeshConfig, global_batch: int,
                    old: Optional[Tuple[Any, MeshConfig]] = None
                    ) -> TrainState:
    """Move a train state onto a new mesh (gather + re-place). ``old``:
    (mesh, mesh config) the state is sharded on, gathered first; None
    where the state holds full arrays (a restored checkpoint). The
    parameters come back as leaves that require grad."""
    if old is not None:
        state = gather_state(state, model, old[0], shd.make_rules(
            model.cfg, old[1], global_batch))
    places = state_shardings(model, new_mesh, new_mesh_cfg, global_batch)
    out = _map(state, places, lambda t, p: p.local(t.detach()))
    for t in out.params.values():
        t.requires_grad_(True)
    return out


def adjust_batch_schedule(global_batch: int, old_dp: int, new_dp: int,
                          step: int) -> Tuple[int, int]:
    """Keep the *global* batch invariant across a data-parallel resize.
    Returns (per_shard_batch, equivalent_step) — the sample counter
    (step * global_batch) is what must be preserved, so the step index
    carries over unchanged while per-shard batch rescales."""
    if global_batch % new_dp:
        raise ValueError(f"global_batch {global_batch} not divisible by "
                         f"new dp degree {new_dp}")
    return global_batch // new_dp, step
