"""Fault-tolerant checkpointing: atomic, async, manifest-driven, in the
JAX package's on-disk layout, so that a checkpoint either package wrote
restores into the other.

Layout (one directory per step):
    ckpt_dir/step_00000100/
        manifest.json       leaf shapes and dtypes, step, metadata
        arrays.npz          flattened leaves keyed by tree path
    ckpt_dir/LATEST         text file with the newest complete step

Leaves are keyed by tree path as the JAX ``_flatten_with_paths`` names
them: nested dict keys and sequence indices joined by ``/``. A
``TrainState`` is the JAX pytree of two children: ``0/<param path>`` and
``1/m/...``, ``1/v/...``, ``1/step``, each layer's leaf stacked on a
leading ``layers`` axis (``convert.model_params_to_jax``). Writes go to a
``.tmp`` directory first and are renamed only after fsync, so a crash
mid-save never corrupts the previous checkpoint. ``AsyncCheckpointer``
copies the state to the host, then persists it on a background thread.

A state sharded on a mesh of more than one rank (``model=`` under the
ambient ``ShardCtx``) is saved as its full arrays: every rank of the
mesh gathers them, the mesh's rank 0 writes, and the others wait for it.
So a checkpoint stays mesh-agnostic (JAX ``train/elastic.py``): it
restores as full arrays, and ``elastic.elastic_reshard`` places them on
any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.train.train_step import TrainState


def _jax_view(tree):
    """A ``TrainState`` as the JAX pytree it stands for; any other tree
    as it is."""
    if not isinstance(tree, TrainState):
        return tree
    opt = {k: convert.model_params_to_jax(tree.opt[k]) for k in ("m", "v")}
    opt["step"] = tree.opt["step"]
    return [convert.model_params_to_jax(tree.params), opt]


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, TrainState):
        return _flatten_with_paths(_jax_view(tree), prefix)
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    flat: Dict[str, Any] = {}
    for key, val in items:
        flat.update(_flatten_with_paths(val, f"{prefix}{key}/"))
    return flat


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(ckpt_dir: Path, state, step: int,
                    metadata: Optional[Dict] = None, model=None) -> Path:
    """Write ``state`` as step ``step``. ``model``: the state's model,
    where the state may be sharded on the ambient mesh (then every rank
    of the mesh calls this)."""
    ctx = shd.mesh_ctx()
    if model is not None and ctx is not None:
        from repro_torch.train.elastic import gather_state
        full = gather_state(state, model, ctx.mesh, ctx.rules)
        path = Path(ckpt_dir) / f"step_{step:08d}"
        if ctx.mesh.rank == 0:
            path = save_checkpoint(ckpt_dir, full, step, metadata)
        col.all_reduce(torch.zeros((), device=ctx.mesh.device), ctx.mesh,
                       ctx.mesh.axes, kind="barrier")
        return path
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {k: _host(v) for k, v in _flatten_with_paths(state).items()}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "metadata": metadata or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "saved_at": time.time(),
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest = ckpt_dir / "LATEST"
    latest_tmp = ckpt_dir / ".LATEST.tmp"
    latest_tmp.write_text(final.name)
    os.replace(latest_tmp, latest)
    return final


def latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    ckpt_dir = Path(ckpt_dir)
    latest = ckpt_dir / "LATEST"
    if not latest.exists():
        steps = sorted(ckpt_dir.glob("step_*"))
        return steps[-1] if steps else None
    path = ckpt_dir / latest.read_text().strip()
    return path if path.exists() else None


@torch.no_grad()
def restore_checkpoint(path: Path, like):
    """Restore into ``like`` (a ``TrainState``, or nested dicts and lists
    of tensors), in place: each leaf is overwritten with the stored array
    of its path, which must have its shape; ``like`` is returned. (The
    JAX function builds a new tree from a tree of shapes; writing into the
    state that training already holds keeps one copy of it on the
    card.)"""
    path = Path(path)
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    targets = _targets(like)
    missing = set(targets) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    for key, (leaves, layered) in targets.items():
        shape = tuple(leaves[0].shape)
        if layered:
            shape = (len(leaves), *shape)
        if arrays[key].shape != shape:
            raise ValueError(f"{key}: stored {arrays[key].shape}, the state "
                             f"holds {shape}")
        for i, t in enumerate(leaves):
            t.copy_(torch.from_numpy(np.array(arrays[key][i] if layered
                                              else arrays[key])))
    return like


def _targets(like) -> Dict[str, tuple]:
    """Stored path -> (the tensors of ``like`` it fills, whether they are
    the layers of a stacked array, in layer order)."""
    if not isinstance(like, TrainState):
        return {k: ([t], False)
                for k, t in _flatten_with_paths(like).items()}
    out = {}
    for prefix, params in (("0", like.params), ("1/m", like.opt["m"]),
                           ("1/v", like.opt["v"])):
        by_key: Dict[str, Dict[int, torch.Tensor]] = {}
        for name, t in params.items():
            key, layer = convert._jax_key(name)
            by_key.setdefault(key, {})[-1 if layer is None else layer] = t
        for key, v in by_key.items():
            out[f"{prefix}/{key}"] = ([v[i] for i in sorted(v)],
                                      -1 not in v)
    out["1/step"] = ([like.opt["step"]], False)
    return out


def read_manifest(path: Path) -> Dict:
    with open(Path(path) / "manifest.json") as f:
        return json.load(f)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, persist asynchronously; keeps
    the newest ``keep`` checkpoints. A failed write is raised by the next
    ``save`` or ``wait``."""

    def __init__(self, ckpt_dir: Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved_step: Optional[int] = None

    def save(self, state, step: int, metadata: Optional[Dict] = None,
             block: bool = False) -> None:
        self.wait()
        # the host copy now, so training can update the tensors in place
        host_state = {k: _host(v).copy()
                      for k, v in _flatten_with_paths(state).items()}

        def work():
            try:
                save_checkpoint(self.ckpt_dir, host_state, step, metadata)
                self.last_saved_step = step
                self._gc()
            except BaseException as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.ckpt_dir.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)
