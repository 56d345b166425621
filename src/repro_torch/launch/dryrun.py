"""Multi-pod dry-run: every (arch x shape x mesh) cell, one rank of it.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell's
step for 256 or 512 placeholder devices and reads the compiler's
``memory_analysis`` and ``cost_analysis``. The port has no compiler to
ask. One process stands as rank ``--rank`` of the mesh's world, joined
by the ``fake`` process group (every collective a no-op, still counted
in ``distributed/collectives.STATS``), and runs the cell's step as that
rank: the same profile, rules, ``ShardCtx``, model, state or cache, and
step factories as JAX's ``lower_cell``, at the production shapes.

Two modes, chosen by ``--device`` and never falling back to each other:

- ``meta``, the dry-run proper: every tensor is a shape, no kernel and
  no card is touched, and the kernels' plain versions trace the shapes.
  The record's peak is the most live tensor bytes at once, its flops
  those of ``torch.utils.flop_counter``'s formulas (remat's recompute
  included), both tallied by ``StepTally`` and both of the plain
  versions (``peak_of`` and ``flops_of`` say so): the plain attention's
  materialized softmax, all S x S scores where the card's K5 walks a
  window, counts in both.
- the card (the default): the rank's parameter shards are drawn from
  a fixed seed and the step runs once through the hand kernels at the
  rank's shapes. Under the fake world a gather holds only the rank's own
  slice, so the values mean nothing; what this mode measures is bytes
  (``torch.cuda.max_memory_allocated()`` after a reset, the whole layer
  that ``Model.init`` draws before it cuts included), the kernels'
  launches by design, and the step's seconds on CUDA events. The hand
  kernels launch through ``ctypes``, unseen by a dispatch mode, so the
  card's record counts no flops (the meta record of the cell does), and
  its step runs under no mode.
  ``cpu`` realizes on the CPU as the tests do, counted as ``meta`` is.

Decode runs at ``pos = seq_len - 1``, a full cache, as the fixed-shape
JAX step pays for its capacity; on meta ``pos`` is a 0-d CPU tensor,
which the step reads on the host.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \
        --mesh both                                   # every cell, traced
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b \
        --shape train_4k --mesh single                # one rank, on the card
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch._device import resolve_device
from repro_torch.configs import (
    ARCHS, SHAPES_BY_NAME, applicable_shapes, get_config, skipped_cells,
)
from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import counting_wrappers, zero_launches
from repro_torch.launch.mesh import (
    make_mesh_from_config, make_production_mesh, mesh_config,
)
from repro_torch.models import build_model
from repro_torch.models.model import input_specs
from repro_torch.models.transformer import STUB_INPUTS
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train.compression import int8_leaves
from repro_torch.train.train_step import (
    choose_microbatches, choose_remat_group, init_train_state,
    local_batch, make_train_step,
)

DEFAULT_OUT = Path("build/dryrun")
#: the meshes ``run`` builds by name (JAX ``run``'s ``extra`` beside the
#: two production meshes)
EXTRA_MESHES = {
    "quad": MeshConfig((4, 16, 16), ("pod", "data", "model")),
    "degraded": MeshConfig((8, 16), ("data", "model")),
}
#: the seeds of a realized cell's weights and of its batch: the values
#: mean nothing under the fake world, so nothing chooses them
WEIGHT_SEED, DATA_SEED = 0, 1
#: what a traced (or CPU-realized) record's peak and flops measure: the
#: kernels' plain versions, not the kernels the card runs (the plain
#: attention materializes its softmax, all S x S scores even where the
#: attention is windowed, and the SSD scan takes its plain form), so
#: neither is the card's work or memory
PLAIN_PEAK = "live tensor bytes of the plain versions"
PLAIN_FLOPS = "matrix products of the plain versions"


def mesh_config_of(name: str) -> MeshConfig:
    """The ``MeshConfig`` of a mesh name of ``--mesh``."""
    if name in EXTRA_MESHES:
        return EXTRA_MESHES[name]
    return mesh_config(multi_pod=(name == "multi"))


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank ``rank`` of a world of ``world`` ranks under
    the ``fake`` backend: groups are made and collectives return at once,
    moving nothing. The default process group is destroyed on exit."""
    # torch.testing._internal is private PyTorch API; only this module
    # imports it
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized;"
                           " the dry-run makes its own world")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(name: str, device):
    """The mesh ``name`` over the whole world: the production meshes
    through ``make_production_mesh`` (which checks the world's size)."""
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=(name == "multi"),
                                    device=device)
    return make_mesh_from_config(EXTRA_MESHES[name], device)


class StepTally(TorchDispatchMode):
    """What the ops run under it cost: ``flops`` by the formulas of
    ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry: the
    matrix products, 2 m n k each), and the bytes of the storages they
    make, from the op that makes each until it is freed: ``live`` now,
    ``peak`` the most at once. One mode for both: ``FlopCounterMode``
    stacked on a second mode doubled a full-width SSM prefill's trace."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        #: id of each storage held -> (a weak reference to it, its bytes)
        self._held: Dict[int, Tuple[weakref.ref, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(getattr(func, "_overloadpacket", None))
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if isinstance(out, torch.Tensor):
            self._track(out)
        else:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._held:
            return
        n = storage.nbytes()
        self._held[key] = (weakref.ref(storage, self._freer(key)), n)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _freer(self, key: int):
        def free(_ref):
            self.live -= self._held.pop(key)[1]
        return free


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree (dicts, a ``TrainState``)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def _fill(batch: Dict[str, Any], cfg: ModelConfig,
          generator: torch.Generator) -> None:
    """Random token ids and stub embeddings (normal x 0.02) into the
    empty batch tensors, in place."""
    for key in ("tokens", "targets"):
        if key in batch:
            batch[key].random_(0, cfg.vocab_size, generator=generator)
    stub = STUB_INPUTS.get(cfg.family)
    if stub in batch:
        x = batch[stub]
        x.copy_(torch.randn(x.shape, generator=generator, device=x.device)
                * 0.02)


@dataclasses.dataclass
class Cell:
    """One rank's cell, built and ready to step (``build_cell``)."""
    rec: Dict[str, Any]
    ctx: shd.ShardCtx
    run: Any


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
               mesh, variant: Optional[Dict[str, Any]] = None) -> Cell:
    """The rank's model, state (or parameters and cache), batch and step
    for one cell, as JAX's ``lower_cell`` builds them (its
    ``launch/dryrun.py:113-204``), on ``mesh.device``; the record holds
    what building found (profile, state and cache bytes). ``run()`` steps
    once."""
    variant = variant or {}
    dev = mesh.device
    realize = dev.type != "meta"
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": {"shape": list(mesh_cfg.shape), "axes": list(mesh_cfg.axes)},
        "chips": mesh_cfg.num_devices, "variant": variant,
        "rank": mesh.rank, "device": dev.type,
    }
    profile = shd.sharding_profile(cfg, mesh_cfg, shape.global_batch,
                                   shape.seq_len, shape.kind)
    rules = shd.make_rules(cfg, mesh_cfg, shape.global_batch,
                           shape.seq_len, shape.kind)
    rec["profile"] = {
        "attn_tp": profile.attn_tp, "mlp_tp": profile.mlp_tp,
        "vocab_tp": profile.vocab_tp, "expert_tp": profile.expert_tp,
        "ssd_tp": profile.ssd_tp, "kv_repeat": profile.kv_repeat,
        "kv_seq_shard": profile.kv_seq_shard,
        "batch_axes": list(profile.batch_axes), "notes": list(profile.notes),
    }
    remat_group = 0
    if shape.kind == "train":
        mu_probe = choose_microbatches(cfg, shape, mesh_cfg, profile)
        remat_group = variant.get("remat_group") or choose_remat_group(
            cfg, shape, mesh_cfg, profile, mu_probe)
    if "remat" in variant:
        cfg = dataclasses.replace(cfg, remat=variant["remat"])
    if "param_dtype" in variant:
        cfg = dataclasses.replace(cfg, param_dtype=variant["param_dtype"])
    rec["profile"]["remat_group"] = remat_group
    ctx = shd.ShardCtx(mesh=mesh, rules=rules, profile=profile)
    weights = torch.Generator(device=dev if realize else "cpu")
    weights.manual_seed(WEIGHT_SEED)
    data = torch.Generator(device=dev if realize else "cpu")
    data.manual_seed(DATA_SEED)

    with shd.use_ctx(ctx):
        model = build_model(cfg, kv_repeat=profile.kv_repeat,
                            remat_group=remat_group,
                            causal_skip=variant.get("causal_skip", False),
                            kv_cache_bits=variant.get("kv_bits", 16),
                            kv_dus_write=variant.get("kv_dus", False),
                            device=dev)
        batch, _ = input_specs(cfg, shape, model)
        if realize:
            _fill(batch, cfg, data)
        if shape.kind == "train":
            mu = variant.get("mu") or choose_microbatches(
                cfg, shape, mesh_cfg, profile)
            rec["profile"]["num_microbatches"] = mu
            step = make_train_step(
                model, num_microbatches=mu,
                grad_transform=int8_leaves if variant.get("compress_grads")
                else None)
            state = init_train_state(model, weights)
            rec["state_bytes_per_device"] = tree_bytes(state)

            def run():
                return step(state, batch)
        elif shape.kind == "prefill":
            pstep = make_prefill_step(model, max_len=shape.seq_len)
            params = model.init(weights)
            rec["state_bytes_per_device"] = tree_bytes(params)
            local = local_batch(batch, ctx)

            def run():
                return pstep(params, local)
        else:  # decode
            dstep = make_decode_step(model)
            params = model.init(weights)
            cache = batch["cache"]
            pos = shape.seq_len - 1
            if realize:
                cache["pos"].fill_(pos)
            else:
                cache["pos"] = torch.full((), pos, dtype=torch.int32)
            rec["decode_pos"] = pos
            rec["state_bytes_per_device"] = tree_bytes(params)
            rec["cache_bytes_per_device"] = tree_bytes(cache)
            tokens = local_batch({"tokens": batch["tokens"]}, ctx)["tokens"]

            def run():
                return dstep(params, tokens, cache)
    rec["model_params"] = cfg.param_count()
    rec["model_active_params"] = cfg.active_param_count()
    return Cell(rec=rec, ctx=ctx, run=run)


def _collectives() -> Dict[str, Dict[str, int]]:
    return {k: {"count": int(v["calls"]), "bytes": int(v["bytes"])}
            for k, v in sorted(col.STATS.items())}


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
               mesh, variant: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Build one cell (``build_cell``) and step it once as this rank;
    return the dry-run record (JAX's ``lower_cell``). ``variant``: §Perf
    knobs — {causal_skip, kv_bits, compress_grads, remat, mu,
    param_dtype, remat_group, kv_dus} override the baseline program."""
    dev = mesh.device
    col.reset_stats()
    if dev.type == "cuda":
        return _realize_on_card(cfg, shape, mesh_cfg, mesh, variant)
    with StepTally() as tally:
        cell = build_cell(cfg, shape, mesh_cfg, mesh, variant)
        rec = cell.rec
        t0 = time.perf_counter()
        with shd.use_ctx(cell.ctx):
            out = cell.run()
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
        del out, cell
    rec["memory"] = {"state_bytes": rec["state_bytes_per_device"]
                     + rec.get("cache_bytes_per_device", 0),
                     "peak_bytes": tally.peak, "peak_of": PLAIN_PEAK}
    rec["cost"] = {"flops": int(tally.flops), "flops_of": PLAIN_FLOPS}
    rec["collectives"] = _collectives()
    return rec


def _realize_on_card(cfg, shape, mesh_cfg, mesh, variant) -> Dict[str, Any]:
    """``lower_cell`` on the card: the step once through the hand kernels,
    timed on CUDA events; the peak from the allocator."""
    dev = mesh.device
    wrappers = counting_wrappers()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cell = build_cell(cfg, shape, mesh_cfg, mesh, variant)
    rec = cell.rec
    zero_launches(wrappers.values())
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with shd.use_ctx(cell.ctx):
        start.record()
        out = cell.run()
        end.record()
    torch.cuda.synchronize(dev)
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    rec["step_s"] = start.elapsed_time(end) / 1e3
    del out, cell
    rec["memory"] = {"state_bytes": rec["state_bytes_per_device"]
                     + rec.get("cache_bytes_per_device", 0),
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "peak_of": "torch.cuda.max_memory_allocated"}
    rec["cost"] = {"flops": None, "flops_of": "not counted: the hand "
                   "kernels launch through ctypes, unseen by a dispatch "
                   "mode"}
    rec["launches"] = {
        key: {"launches": fn.launches,
              "by_design": dict(getattr(fn, "launches_by_design", {}))}
        for key, fn in wrappers.items()}
    rec["collectives"] = _collectives()
    return rec


def run(archs, shapes, meshes, out_dir: Path, skip_existing: bool = False,
        device=None, rank: int = 0, variant: Optional[Dict[str, Any]] = None
        ) -> Tuple[int, int]:
    """Every applicable (arch, shape) cell on each mesh of ``meshes``, as
    rank ``rank`` of a fake world of the mesh's size on ``device``
    (``None``: the card); one JSON record a cell in ``out_dir``, and
    ``skipped.json``. Returns (ok, failed)."""
    dev = resolve_device(device)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = failed = 0
    for mesh_name in meshes:
        mcfg = mesh_config_of(mesh_name)
        with fake_world(mcfg.num_devices, rank):
            mesh = make_mesh(mesh_name, dev)
            for arch in archs:
                cfg = get_config(arch)
                valid = {s.name for s in applicable_shapes(cfg)}
                for shape_name in shapes:
                    if shape_name not in valid:
                        continue
                    shape = SHAPES_BY_NAME[shape_name]
                    tag = f"{mesh_name}__{arch}__{shape_name}"
                    path = out_dir / f"{tag}.json"
                    if skip_existing and path.exists():
                        existing = json.loads(path.read_text())
                        if "error" not in existing:
                            print(f"[skip] {tag}")
                            ok += 1
                            continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    t0 = time.time()
                    try:
                        rec = lower_cell(cfg, shape, mcfg, mesh,
                                         variant=variant)
                        rec["total_s"] = round(time.time() - t0, 2)
                        path.write_text(json.dumps(rec, indent=2))
                        print(f"  ok in {rec['total_s']}s  "
                              + _summary(rec), flush=True)
                        ok += 1
                    except Exception as e:
                        failed += 1
                        err = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "error": str(e),
                               "traceback": traceback.format_exc()}
                        path.write_text(json.dumps(err, indent=2))
                        print(f"  FAILED: {e}", flush=True)
    # record assigned-but-skipped cells for the report
    (out_dir / "skipped.json").write_text(
        json.dumps([{"arch": a, "shape": s, "reason": r}
                    for a, s, r in skipped_cells()], indent=2))
    return ok, failed


def _summary(rec: Dict[str, Any]) -> str:
    flops = rec["cost"]["flops"]
    line = (f"state={rec['state_bytes_per_device'] / 2**30:.2f}GiB "
            f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
            + (f"flops={flops:.3e} " if flops is not None else "")
            + f"colls={ {k: v['count'] for k, v in rec['collectives'].items()} }")
    if "step_s" in rec:
        line += (f" step={rec['step_s']:.3f}s launches="
                 f"{ {k: v['launches'] for k, v in rec['launches'].items() if v['launches']} }")
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable; default all)")
    ap.add_argument("--shape", action="append", default=None,
                    help="shape name (repeatable; default all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both",
                                       "quad", "degraded"],
                    default="both",
                    help="quad: 4x16x16=1024 ranks; degraded: 8x16 "
                         "(half-pod elastic-restart mesh)")
    ap.add_argument("--device", default=None,
                    help="meta: trace the shapes (the dry-run proper); cpu: "
                         "realize on the CPU; default: one rank realized "
                         "on the card")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh's world this process stands "
                         "as")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=16)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", choices=["full", "dots"], default=None)
    ap.add_argument("--mu", type=int, default=None)
    ap.add_argument("--param-dtype", default=None,
                    help="serve in bf16: --param-dtype bfloat16")
    ap.add_argument("--remat-group", type=int, default=None)
    ap.add_argument("--kv-dus", action="store_true",
                    help="per-shard DUS cache write (SPerf C3)")
    args = ap.parse_args(argv)
    variant: Dict[str, Any] = {}
    if args.causal_skip:
        variant["causal_skip"] = True
    if args.kv_bits != 16:
        variant["kv_bits"] = args.kv_bits
    if args.compress_grads:
        variant["compress_grads"] = True
    if args.remat:
        variant["remat"] = args.remat
    if args.mu:
        variant["mu"] = args.mu
    if args.param_dtype:
        variant["param_dtype"] = args.param_dtype
    if args.remat_group:
        variant["remat_group"] = args.remat_group
    if args.kv_dus:
        variant["kv_dus"] = True

    archs = args.arch or sorted(ARCHS)
    shapes = args.shape or list(SHAPES_BY_NAME)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    ok, failed = run(archs, shapes, meshes, args.out,
                     skip_existing=args.skip_existing, device=args.device,
                     rank=args.rank, variant=variant)
    print(f"\ndry-run complete: {ok} ok, {failed} failed")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
