"""Mesh construction and the process world that carries it.

``make_mesh_from_config`` lays a ``MeshConfig`` over the ranks of the
default process group (``distributed.collectives.Mesh``); ``mesh_config``
names the production meshes, and ``make_production_mesh`` builds one only
in a world of 256 (single pod) or 512 (multi-pod) ranks. Nothing here
touches a device at import.

``spawn_world`` runs ``fn(rank, *args)`` in ``world`` processes joined by
a ``FileStore`` (a file, not a TCP port, so that concurrent worlds on one
host cannot clash), each with a deadline: the process group's timeout,
and a join deadline after which every rank still alive is terminated. A
rank that fails terminates the others, and the failure is raised with
every failed rank's traceback, the earliest written first: once one rank
has failed the others get ``FAILURE_GRACE_S`` to exit, since a rank left
waiting in a collective may fail and exit before the rank that caused
it. ``fn`` must be importable by name from the child
(a module-level function), as the ``spawn`` start method requires.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.configs.base import MULTI_POD_MESH, SINGLE_POD_MESH, \
    MeshConfig


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


def make_mesh_from_config(cfg: MeshConfig, device=None,
                          ranks: Optional[Sequence[int]] = None):
    """``cfg`` over ``ranks`` of the default process group (all of them by
    default) on ``device`` (``None``: the card)."""
    from repro_torch._device import resolve_device
    from repro_torch.distributed.collectives import Mesh
    return Mesh(cfg, resolve_device(device), ranks=ranks)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) or (2, 16, 16) mesh; raises unless the world holds 256
    or 512 ranks to match."""
    import torch.distributed as dist
    cfg = mesh_config(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cfg.num_devices:
        raise RuntimeError(f"the production mesh {cfg.shape} needs "
                           f"{cfg.num_devices} ranks; this world has {world}")
    return make_mesh_from_config(cfg, device)


def _rank_main(fn: Callable, rank: int, world: int, init_file: str,
               device: str, timeout_s: float, args: tuple, out: str,
               threads: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.collectives import choose_backend
    try:
        if threads:
            torch.set_num_threads(threads)
        backend, why = choose_backend(device, world)
        if rank == 0:
            print(f"world: backend {backend}: {why}", flush=True)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else rank if backend == "nccl" else 0)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(rank, *args)
        dist.destroy_process_group()
        with open(f"{out}.{rank}.tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(f"{out}.{rank}.tmp", f"{out}.{rank}")
    except BaseException:
        Path(f"{out}.{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


class WorldError(RuntimeError):
    """A rank of a spawned world failed or missed its deadline."""


#: seconds the other ranks get to exit once one rank has failed
FAILURE_GRACE_S = 10.0


def _await_exits(procs, until: float) -> None:
    while time.monotonic() < until and any(p.exitcode is None
                                           for p in procs):
        time.sleep(0.05)


def _failure_report(out: str, procs, world: int) -> str:
    """Which ranks failed, and each error file's traceback, in the order
    the files were written."""
    codes = [p.exitcode for p in procs]
    errs = sorted((e.stat().st_mtime_ns, r, e) for r in range(world)
                  for e in [Path(f"{out}.{r}.err")] if e.exists())
    bad = sorted({r for r, c in enumerate(codes) if c not in (None, 0)}
                 | {r for _, r, _ in errs})
    text = "".join(f"--- rank {r} ---\n{e.read_text()}" for _, r, e in errs)
    return (f"rank(s) {bad} of {world} failed (exit codes {codes}; errors "
            f"in the order written: {[r for _, r, _ in errs]}):\n{text}")


def spawn_world(fn: Callable, world: int, args: tuple = (), *,
                device: str = "cpu", timeout_s: float = 120.0,
                threads: int = 1, workdir: Optional[Path] = None
                ) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` ranks; returns each rank's
    result (picklable), in rank order. ``timeout_s`` bounds each
    collective and the whole run. ``threads``: torch threads a rank (0
    leaves the default)."""
    own = workdir is None
    work = Path(tempfile.mkdtemp(prefix="world_")) if own else Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    init_file = str(work / "store")
    if os.path.exists(init_file):
        os.remove(init_file)
    out = str(work / "result")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init_file, str(device),
                               timeout_s, args, out, threads),
                         name=f"world-rank-{r}") for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                # the rank left waiting in a collective may exit before
                # the rank that failed it: let the others exit, then
                # report every error, the earliest written first
                _await_exits(procs, min(deadline, time.monotonic()
                                        + FAILURE_GRACE_S))
                raise WorldError(_failure_report(out, procs, world))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise WorldError(f"world of {world} missed its {timeout_s} s "
                                 f"deadline (exit codes {codes})")
            time.sleep(0.05)
        results = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        if own:
            import shutil
            shutil.rmtree(work, ignore_errors=True)
