"""Carry state from the JAX package into the port: an engine's window
state (``engine_state_from_jax``), a serving cache's KV pages
(``tiered_kv_cache_from_jax``), and a model's parameters and a train state
(``model_params_from_jax``, ``train_state_from_jax``; the reverse,
``model_params_to_jax``, gives the JAX tree that checkpoints store), a
rank's shards of a model's parameters on a mesh (``shard_params_from_jax``;
the reverse, ``gather_params_to_jax``), and a model's decode cache
(``model_cache_from_jax``).

A streaming engine carries window state where a model carries weights.
``engine_state_from_jax(snap)`` takes the dict that the JAX package's
``StreamEngine.checkpoint_state()`` returns (plain lists and numpy
arrays; nothing of JAX in it) and returns the input that
``repro_torch.core.StreamEngine.restore_state`` takes. Inline blocks keep
their event arrays; manifest blocks (``stored: True``) stay references
into the log store the JAX package wrote, whose on-disk format the port
reads unchanged, so the port's engine must be opened on that store.

The conversion validates what would otherwise make the two engines
silently compute different things: fills against the block arrays, block
ids (present, integral, unique), window bounds and the lateness
histogram's shape.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.transformer import STACKED

#: bins of the port's ``LatenessHistogram`` (and of the JAX package's)
HIST_BINS = 256


def _block(b: Dict[str, Any], where: str, seen: set) -> Dict[str, Any]:
    fill = int(b["fill"])
    if fill < 0:
        raise ValueError(f"{where}: negative fill {fill}")
    if "block_id" not in b:
        raise ValueError(f"{where}: block without a block_id")
    bid = int(b["block_id"])
    if bid != b["block_id"] or bid <= 0 or bid in seen:
        raise ValueError(f"{where}: bad or duplicate block_id "
                         f"{b['block_id']!r}")
    seen.add(bid)
    out = {"fill": fill, "block_id": bid, "tier": b.get("tier"),
           "persisted": bool(b.get("persisted", False))}
    stored = bool(b.get("stored", False))
    data = b.get("data") or {}
    if stored and not data:
        out["stored"] = True
        out["data"] = {}
        return out
    if fill and not data:
        raise ValueError(f"{where}: fill {fill} but no event data")
    arrays = {}
    for key, dtype in (("keys", np.int32), ("timestamps", np.float64),
                       ("values", np.float32)):
        if data:
            arr = np.asarray(data[key], dtype)
            if arr.shape[0] < fill:
                raise ValueError(f"{where}: {key} holds {arr.shape[0]} "
                                 f"rows, fill is {fill}")
            arrays[key] = arr
    if data and arrays["values"].ndim != 2:
        raise ValueError(f"{where}: values must be [capacity, width]")
    out["data"] = arrays
    if stored:
        out["stored"] = True
    return out


def engine_state_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """``repro.core.StreamEngine.checkpoint_state()`` output ->
    ``repro_torch.core.StreamEngine.restore_state`` input."""
    counts = np.asarray(snap["hist_counts"], np.float32)
    if counts.shape != (HIST_BINS,):
        raise ValueError(f"hist_counts must have shape ({HIST_BINS},), "
                         f"got {counts.shape}")
    total = int(snap["hist_total"])
    if total < 0:
        raise ValueError(f"negative hist_total {total}")
    seen: set = set()
    windows = []
    for w in snap["windows"]:
        start, end = float(w["start"]), float(w["end"])
        if not end > start:
            raise ValueError(f"window [{start}, {end}) is empty")
        where = f"window [{start}, {end})"
        blocks = [_block(b, f"{where} block {i}", seen)
                  for i, b in enumerate(w["blocks"])]
        total_events = int(w["total_events"])
        if sum(b["fill"] for b in blocks) != total_events:
            raise ValueError(f"{where}: block fills do not add up to "
                             f"total_events {total_events}")
        windows.append({"start": start, "end": end,
                        "total_events": total_events,
                        "late_events": int(w["late_events"]),
                        "expired": bool(w["expired"]),
                        "blocks": blocks})
    return {"watermark": float(snap["watermark"]), "hist_counts": counts,
            "hist_total": total, "windows": windows}


# ------------------------------------------------------------- serving
def _host_tensor(a: Any) -> torch.Tensor:
    """A numpy array as a CPU tensor of its own type. bfloat16 (numpy's
    ``ml_dtypes.bfloat16``, as ``np.asarray`` gives a JAX bf16 array) is
    reinterpreted bit for bit through int16, never rounded through
    float32."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tiered_kv_cache_from_jax(state: Dict[str, Any], *,
                             cleanup: Optional[Any] = None, device=None):
    """A JAX ``repro.serve.TieredKVCache``'s state, as plain Python and
    numpy, -> a ``repro_torch.serve.TieredKVCache`` that continues
    identically (same pages, owners, free list, policy state and pool
    bits).

    ``state`` holds ``k_pool`` / ``v_pool`` (numpy ``[L, P, page, Hkv,
    D]``, as ``np.asarray`` gives them), ``sessions`` (session id -> a
    dict of the ``Session`` fields: ``length``, ``pages``, ``host_pages``
    {logical page: (k, v) numpy ``[L, page, Hkv, D]``}, ``last_arrival``,
    ``gap_ewma``, ``finished``), ``owner`` {device page: (session id,
    logical page)}, ``free_pages`` (in order) and ``stats``; optionally
    ``cleanup``, the ``PredictiveCleanup`` fields (``coverage``,
    ``confidence``, ``initial_bound``, ``min_history``, ``bound``,
    ``hist_counts``, ``hist_total``). A ``cleanup`` argument replaces the
    state's.

    Validated: pool shapes, every session page in range and owned by that
    session's slot, every host page at a non-resident slot, and the free
    list free of duplicates and disjoint from the owned pages."""
    from repro_torch.core.cleanup import LatenessHistogram, \
        PredictiveCleanup
    from repro_torch.serve.kvcache import Session, TieredKVCache

    k_pool = _host_tensor(state["k_pool"])
    v_pool = _host_tensor(state["v_pool"])
    if k_pool.dim() != 5 or v_pool.shape != k_pool.shape \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError("k_pool / v_pool must be one [L, P, page, Hkv, D] "
                         f"shape and type, got {tuple(k_pool.shape)} "
                         f"{k_pool.dtype}, {tuple(v_pool.shape)} "
                         f"{v_pool.dtype}")
    layers, pages, page, hkv, d = k_pool.shape
    host_shape = (layers, page, hkv, d)

    owner = {int(pg): (int(o[0]), int(o[1]))
             for pg, o in state["owner"].items()}
    sessions = {}
    for sid, sd in state["sessions"].items():
        sid = int(sid)
        s = Session(session_id=sid, length=int(sd["length"]),
                    pages=[int(p) for p in sd["pages"]],
                    last_arrival=float(sd["last_arrival"]),
                    gap_ewma=float(sd["gap_ewma"]),
                    finished=bool(sd["finished"]))
        for li, pg in enumerate(s.pages):
            if not -1 <= pg < pages:
                raise ValueError(f"session {sid} page {li}: {pg} is not a "
                                 f"device page of {pages}")
            if pg >= 0 and owner.get(pg) != (sid, li):
                raise ValueError(f"device page {pg} is session {sid}'s "
                                 f"page {li} but owned by {owner.get(pg)}")
        for li, (k, v) in sd["host_pages"].items():
            li = int(li)
            if not 0 <= li < len(s.pages) or s.pages[li] != -1:
                raise ValueError(f"session {sid}: host page {li} at a "
                                 "resident or missing slot")
            kt, vt = _host_tensor(k), _host_tensor(v)
            if tuple(kt.shape) != host_shape or kt.shape != vt.shape \
                    or kt.dtype != k_pool.dtype or vt.dtype != k_pool.dtype:
                raise ValueError(f"session {sid}: host page {li} must be "
                                 f"{host_shape} {k_pool.dtype}")
            s.host_pages[li] = (kt, vt)
        sessions[sid] = s
    for pg, (sid, li) in owner.items():
        s = sessions.get(sid)
        if s is None or li >= len(s.pages) or s.pages[li] != pg:
            raise ValueError(f"owner entry {pg} -> ({sid}, {li}) names no "
                             "such session page")
    free = [int(p) for p in state["free_pages"]]
    if len(set(free)) != len(free) or set(free) & set(owner) \
            or any(not 0 <= p < pages for p in free):
        raise ValueError("free_pages must be distinct device pages that no "
                         "session owns")

    if cleanup is None and state.get("cleanup") is not None:
        cd = state["cleanup"]
        hist = LatenessHistogram(
            counts=np.asarray(cd["hist_counts"], np.float32).copy(),
            total=int(cd["hist_total"]))
        if hist.counts.shape != (hist.num_bins,):
            raise ValueError(f"hist_counts must have shape "
                             f"({hist.num_bins},)")
        cleanup = PredictiveCleanup(
            coverage=float(cd["coverage"]),
            confidence=float(cd["confidence"]),
            initial_bound=float(cd["initial_bound"]),
            min_history=int(cd["min_history"]), hist=hist,
            _bound=float(cd["bound"]))

    cache = TieredKVCache(num_device_pages=pages, page_size=page,
                          num_kv_heads=hkv, head_dim=d, num_layers=layers,
                          dtype=k_pool.dtype, cleanup=cleanup, device=device)
    cache.k_pool.copy_(k_pool)
    cache.v_pool.copy_(v_pool)
    cache.sessions = sessions
    cache.owner = owner
    cache.free_pages = free
    cache.stats = {k: int(v) for k, v in state["stats"].items()}
    return cache


# ------------------------------------------------------------- training


def _jax_key(name: str) -> tuple:
    """A port parameter name -> (its JAX tree path, its layer or None):
    ``layers.3.attn.q.w`` is layer 3 of ``layers/attn/q/w``, and
    ``encoder.1.mlp.up.w`` encoder layer 1 of ``encoder/mlp/up/w``."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0], *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def model_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX model's parameter tree (nested dicts of numpy arrays, as
    ``np.asarray`` gives them; ``layers`` and ``encoder`` stacked on a
    leading axis) -> the port's parameters by name (``Model.init``'s
    keys), as CPU tensors: the stacked axis is split into ``layers.<i>.``
    (``encoder.<i>.``), each array copied."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in _flat(params).items():
        arr = np.asarray(arr)
        parts = key.split("/")
        if parts[0] in STACKED:
            rest = ".".join(parts[1:])
            for i in range(arr.shape[0]):
                out[f"{parts[0]}.{i}.{rest}"] = _host_tensor(arr[i])
        else:
            out[".".join(parts)] = _host_tensor(arr)
    return out


def model_params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The reverse: the port's parameters by name -> the JAX tree of numpy
    arrays, each layer's leaf stacked on a leading ``layers`` (or
    ``encoder``) axis."""
    flat: Dict[str, Any] = {}
    layered: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in params.items():
        key, layer = _jax_key(name)
        arr = t.detach().cpu().numpy()
        if layer is None:
            flat[key] = arr
        else:
            layered.setdefault(key, {})[layer] = arr
    for key, by_layer in layered.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{key}: layers {sorted(by_layer)} are not "
                             "0..L-1")
        flat[key] = np.stack([by_layer[i] for i in range(len(by_layer))])
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def shard_params_from_jax(params: Dict[str, Any], model,
                          ctx=None, device=None) -> Dict[str, torch.Tensor]:
    """A JAX model's parameter tree (numpy) -> this rank's shards of the
    port's parameters on the mesh of ``ctx`` (the ambient ``ShardCtx``
    by default), by ``model.specs()`` and the context's rules, on
    ``device`` (the mesh's by default), as leaf tensors that require
    grad. Without a mesh: the full parameters."""
    from repro_torch.distributed import sharding as shd
    ctx = shd.current_ctx() if ctx is None else ctx
    full = model_params_from_jax(params)
    if ctx is None or ctx.mesh is None:
        dev = device
        return {n: t.to(dev).requires_grad_(True) for n, t in full.items()}
    dev = ctx.mesh.device if device is None else device
    specs = model.specs()
    out = {}
    for n, t in full.items():
        sl = shd.shard_slices(t.shape, ctx.pspec(*specs[n]), ctx.mesh)
        out[n] = t[sl].contiguous().to(dev).requires_grad_(True)
    return out


def gather_params_to_jax(params: Dict[str, torch.Tensor], model,
                         ctx=None) -> Dict[str, Any]:
    """The reverse: every rank's shards gathered (a collective over the
    mesh's ranks) into the JAX tree of full numpy arrays."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.elastic import Placement
    ctx = shd.current_ctx() if ctx is None else ctx
    if ctx is None or ctx.mesh is None:
        return model_params_to_jax(params)
    specs = model.specs()
    full = {n: Placement(ctx.mesh, ctx.pspec(*specs[n])).gather(
        t.detach()).cpu() for n, t in params.items()}
    return model_params_to_jax(full)


def train_state_from_jax(state: Any, device=None):
    """A JAX ``TrainState`` (``params`` and ``opt`` = {``m``, ``v``,
    ``step``}; attributes or mapping keys, arrays or numpy) -> the port's
    ``TrainState`` on ``device`` (``None``: the card), parameters as leaf
    tensors that require grad."""
    from repro_torch._device import resolve_device
    from repro_torch.train.train_step import TrainState

    def get(obj, name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    def as_np(tree):
        return {k: as_np(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in tree.items()}

    dev = resolve_device(device)
    opt = get(state, "opt")
    params = {n: t.to(dev).requires_grad_(True) for n, t in
              model_params_from_jax(as_np(get(state, "params"))).items()}
    moments = {k: {n: t.to(dev) for n, t in
                   model_params_from_jax(as_np(get(opt, k))).items()}
               for k in ("m", "v")}
    step = torch.as_tensor(np.array(get(opt, "step")), dtype=torch.int32,
                           device=dev)
    return TrainState(params=params, opt={**moments, "step": step})


def model_cache_from_jax(cache: Dict[str, Any], device=None
                         ) -> Dict[str, Any]:
    """A JAX ``Model`` decode cache (``pos`` and ``layers``, each leaf
    stacked on a leading layers axis; arrays or numpy) -> the port's
    cache on ``device`` (``None``: the card), every leaf in its own type
    (bfloat16 bit for bit) and ``pos`` a 0-dim int32 tensor, so that the
    port's ``decode_step`` continues from a JAX prefill."""
    from repro_torch._device import resolve_device
    dev = resolve_device(device)
    layers = {k: _host_tensor(np.asarray(v)).to(dev)
              for k, v in cache["layers"].items()}
    pos = torch.tensor(int(np.asarray(cache["pos"])), dtype=torch.int32,
                       device=dev)
    return {"pos": pos, "layers": layers}


def shard_cache(cache: Dict[str, Any], model, ctx=None,
                device=None) -> Dict[str, Any]:
    """A whole decode cache of the port (every leaf at its global shape)
    -> this rank's piece of each leaf on the mesh of ``ctx`` (the ambient
    ``ShardCtx`` by default), by ``model.cache_specs()`` and the
    context's rules, on ``device`` (the mesh's by default); ``pos``
    replicated. Without a mesh: the cache on ``device``."""
    from repro_torch.distributed import sharding as shd
    ctx = shd.current_ctx() if ctx is None else ctx
    if ctx is None or ctx.mesh is None:
        dev = device
        specs, pick = {}, lambda t, n: t
    else:
        dev = ctx.mesh.device if device is None else device
        specs = model.cache_specs()["layers"]

        def pick(t, n):
            return t[shd.shard_slices(t.shape, ctx.pspec(*specs[n]),
                                      ctx.mesh)]
    return {"pos": cache["pos"].to(dev),
            "layers": {n: pick(t, n).contiguous().to(dev)
                       for n, t in cache["layers"].items()}}


def gather_cache(cache: Dict[str, Any], model, ctx=None) -> Dict[str, Any]:
    """The reverse of ``shard_cache``: every rank's pieces gathered (a
    collective over the mesh's ranks) into the whole cache, on the
    host."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.elastic import Placement
    ctx = shd.current_ctx() if ctx is None else ctx
    if ctx is None or ctx.mesh is None:
        return {"pos": cache["pos"].cpu(),
                "layers": {n: t.cpu() for n, t in cache["layers"].items()}}
    specs = model.cache_specs()["layers"]
    return {"pos": cache["pos"].cpu(),
            "layers": {n: Placement(ctx.mesh, ctx.pspec(*specs[n])).gather(
                t).cpu() for n, t in cache["layers"].items()}}
