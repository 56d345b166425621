"""Sharding: the slot mesh of Aion's slot-sharded fold, and the LM half's
logical-axis rules.

The slot mesh (``AionConfig.slot_sharding``).

Window slots partition across a 1-D mesh of devices with NO cross-device
reduction: slots are disjoint, so each device owns a contiguous slot
range outright, and a fold's output is the concatenation of the
per-device tiles along the slot axis. The JAX package runs this as a
``shard_map`` over the local devices of one process; the port runs it in
one process as well: a mesh is a tuple of ``torch.device``, each shard's
kernel launches on its own entry, and the tiles are concatenated on the
first. No collective is involved, so there is no process group.

An entry may repeat a device: ``SlotMesh((cpu,) * 4)`` shards four ways
on one CPU, and ``(cuda:0,) * 4`` on one card. That checks the sharded
placement, masking and per-shard launches where only one device exists
(the counterpart of XLA's forced host device count); it says nothing of
scaling across devices.

The LM half, the JAX module's line for line where it is pure logic:
every parameter and activation of the model code carries *logical* axis
names; ``make_rules`` maps them to physical mesh axes by divisibility
(``sharding_profile``), so the same model code runs on one device, on a
small world of processes and on the 256- and 512-device meshes of the
JAX dry-run. ``logical_to_pspec`` gives one mesh axis (or a tuple of
axes, or ``None``) per dimension, trailing ``None``s trimmed: the port's
counterpart of ``PartitionSpec``. ``ShardCtx`` is the ambient context
(``use_ctx``); its mesh is ``distributed.collectives.Mesh``, a process
group of the port's own design. Where JAX's ``constrain`` asks GSPMD to
move data, the port's model code moves it itself with the collectives of
``distributed/collectives.py``, so ``constrain`` moves nothing: under a
mesh it checks that the local tensor's shape is the rule's shard of the
full shape, and raises where it is not. ``shard_map_compat`` has no
counterpart.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import MeshConfig, ModelConfig

# Default mesh axis for the streaming engine's slot-sharded batched fold.
SLOT_AXIS = "slots"


def shard_of_window(start: float, end: float, num_shards: int) -> int:
    """Stable window -> shard assignment for the pooled sharded fold.

    The block pool places a window's blocks in per-device slot ranges at
    STAGING time — before any batch composition is known — so placement
    must be a pure function of the window identity, not of the batch.
    Both the staging shard hint and the batch executor's pooled placement
    call this, which is what keeps a window's block-table rows local to
    the shard that owns its arena range. Python's float hash is
    process-stable (PYTHONHASHSEED only perturbs str/bytes), and the JAX
    package computes the same one, so a window lands on the same shard in
    both.
    """
    if num_shards <= 1:
        return 0
    return int(abs(hash((float(start), float(end))))) % num_shards


@dataclass(frozen=True)
class SlotMesh:
    """A 1-D mesh: shard ``d`` runs on ``devices[d]``. Hashable."""
    devices: Tuple[torch.device, ...]
    axis_name: str = SLOT_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def _local_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the index its tensors report (``cuda:<current>``), so
    that a tile's device compares equal to its mesh entry."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_slot_mesh(num_devices: int = 0, axis_name: str = SLOT_AXIS,
                   devices: Optional[Sequence] = None
                   ) -> Optional[SlotMesh]:
    """1-D mesh for slot-sharded window execution.

    ``devices=None`` takes the local devices: ``cuda:0`` .. ``cuda:n-1``,
    or the single CPU where CUDA is missing. An explicit ``devices`` list
    may name a device more than once. ``num_devices == 0`` takes every
    entry, else the first ``num_devices``. Returns ``None`` below two
    entries — callers fall back to the single-device batched path, which
    keeps ``slot_sharding=True`` a safe no-op on one device.
    """
    devs = _local_devices() if devices is None else \
        [_indexed(torch.device(d)) for d in devices]
    n = num_devices if num_devices > 0 else len(devs)
    n = min(n, len(devs))
    if n <= 1:
        return None
    return SlotMesh(tuple(devs[:n]), axis_name)


# ---------------------------------------------------------------------------
# The LM half: logical axes and their rules
# ---------------------------------------------------------------------------

# Logical axis vocabulary.
BATCH = "batch"          # global batch dim
SEQ = "seq"              # sequence dim (sharded only for context-parallel opt)
EMBED = "embed"          # d_model dim
FSDP = "fsdp"            # parameter dim sharded ZeRO-style over 'data'
HEADS = "heads"          # query heads
KV_HEADS = "kv_heads"    # stored KV heads (possibly repeated for divisibility)
KV_PARAM_HEADS = "kv_param_heads"  # true KV heads on params (no repeat)
KV_SEQ = "kv_seq"        # KV-cache sequence dim (context-parallel decode)
HEAD_DIM = "head_dim"
MLP = "mlp"              # d_ff dim
VOCAB = "vocab"          # vocabulary dim
EXPERTS = "experts"      # MoE expert dim
SSD_HEADS = "ssd_heads"  # mamba2/SSD head dim
SSD_STATE = "ssd_state"
LAYERS = "layers"        # stacked-layer dim (never sharded)
NULL = None
#: the tensor-parallel mesh axis; every other axis is data-parallel
MODEL_AXIS = "model"


@dataclass(frozen=True)
class ShardingProfile:
    """Which TP dims are actually sharded for a given (arch, mesh)."""
    attn_tp: bool            # heads over 'model'
    mlp_tp: bool             # d_ff over 'model'
    vocab_tp: bool           # padded vocab over 'model'
    expert_tp: bool          # experts over 'model'
    ssd_tp: bool             # SSD heads over 'model'
    kv_repeat: int           # stored-KV replication factor for divisibility
    batch_axes: Tuple[str, ...]
    kv_seq_shard: bool = False  # context-parallel decode cache (seq over model)
    notes: Tuple[str, ...] = ()


def _divides(a: int, b: int) -> bool:
    return b > 0 and a > 0 and a % b == 0


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def sharding_profile(cfg: ModelConfig, mesh_cfg: MeshConfig,
                     global_batch: int, seq_len: int = 0,
                     kind: str = "train") -> ShardingProfile:
    axes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    model = axes.get("model", 1)
    data = axes.get("data", 1)
    pod = axes.get("pod", 1)
    notes = []

    # batch: prefer ('pod','data'); drop axes that don't divide.
    batch_axes: Tuple[str, ...]
    if pod > 1 and _divides(global_batch, pod * data):
        batch_axes = ("pod", "data")
    elif _divides(global_batch, data):
        batch_axes = ("data",)
        if pod > 1:
            notes.append("batch not divisible by pod*data; pod idle on batch")
    else:
        batch_axes = ()
        notes.append(f"global_batch={global_batch} not divisible by data={data};"
                     " batch replicated (latency-bound shape)")

    attn_tp = cfg.has_attention and _divides(cfg.num_heads, model)
    if cfg.has_attention and not attn_tp:
        notes.append(f"num_heads={cfg.num_heads} % model={model} != 0: "
                     "attention is DP-only (TP-MLP hybrid fallback)")
    kv_repeat = 1
    if attn_tp:
        if _divides(cfg.num_kv_heads, model):
            kv_repeat = 1
        else:
            # repeat stored KV heads up to the model axis for divisibility
            kv_repeat = model // cfg.num_kv_heads
            if cfg.num_kv_heads * kv_repeat != model:
                # e.g. kv=3, model=16 -> no clean repeat; give up on attn TP
                attn_tp = False
                kv_repeat = 1
                notes.append("kv head repeat not integral; attention DP-only")
            else:
                notes.append(f"stored KV heads repeated x{kv_repeat} "
                             f"({cfg.num_kv_heads}->{model}) for TP divisibility")

    mlp_tp = cfg.d_ff > 0 and _divides(cfg.d_ff, model)
    vocab_tp = _divides(pad_vocab(cfg.vocab_size), model)
    expert_tp = cfg.moe.enabled and _divides(cfg.moe.num_experts, model)
    ssd_tp = False
    if cfg.ssm.enabled:
        d_inner = cfg.ssm.expand * cfg.d_model
        nheads = d_inner // cfg.ssm.head_dim
        ssd_tp = _divides(nheads, model)
        if not ssd_tp:
            notes.append(f"ssd_heads={nheads} % model={model} != 0: SSM DP-only")

    # Context-parallel decode: the decode KV cache is sequence-sharded over
    # the model axis (no head repeat; the cache shards on seq instead).
    kv_seq_shard = False
    if kind == "decode" and cfg.has_attention:
        kv_repeat = 1
        if cfg.attn_window == 0 and model > 1 and seq_len \
                and seq_len % model == 0:
            kv_seq_shard = True
            notes.append("decode KV cache sequence-sharded over 'model' "
                         "(context-parallel decode, no KV head repeat)")

    return ShardingProfile(
        attn_tp=attn_tp, mlp_tp=mlp_tp, vocab_tp=vocab_tp,
        expert_tp=expert_tp, ssd_tp=ssd_tp, kv_repeat=kv_repeat,
        batch_axes=batch_axes, kv_seq_shard=kv_seq_shard,
        notes=tuple(notes),
    )


def make_rules(cfg: ModelConfig, mesh_cfg: MeshConfig,
               global_batch: int, seq_len: int = 0,
               kind: str = "train") -> Dict[str, Any]:
    """Logical-axis -> physical mesh axis (or None) rule table."""
    prof = sharding_profile(cfg, mesh_cfg, global_batch, seq_len, kind)
    model_size = dict(zip(mesh_cfg.axes, mesh_cfg.shape)).get("model", 1)
    kv_param_tp = prof.attn_tp and cfg.num_kv_heads % max(model_size, 1) == 0
    rules: Dict[str, Any] = {
        BATCH: prof.batch_axes if prof.batch_axes else None,
        SEQ: None,
        EMBED: None,
        FSDP: "data" if "data" in mesh_cfg.axes else None,
        HEADS: "model" if prof.attn_tp else None,
        # stored-KV head activations: head-sharded for train/prefill (via
        # repeat); unsharded for decode (the cache shards on seq instead)
        KV_HEADS: "model" if (prof.attn_tp and kind != "decode") else None,
        KV_PARAM_HEADS: "model" if kv_param_tp else None,
        KV_SEQ: "model" if prof.kv_seq_shard else None,
        HEAD_DIM: None,
        MLP: "model" if prof.mlp_tp else None,
        VOCAB: "model" if prof.vocab_tp else None,
        EXPERTS: "model" if prof.expert_tp else None,
        SSD_HEADS: "model" if prof.ssd_tp else None,
        SSD_STATE: None,
        LAYERS: None,
    }
    return rules


def logical_to_pspec(logical: Tuple[Optional[str], ...],
                     rules: Dict[str, Any]) -> Tuple[Any, ...]:
    """One mesh axis, tuple of axes or ``None`` per dim, trailing
    ``None``s trimmed (JAX's ``P(*phys)``)."""
    phys = [None if ax is None else rules.get(ax) for ax in logical]
    while phys and phys[-1] is None:
        phys.pop()
    return tuple(phys)


def entry_axes(entry) -> Tuple[str, ...]:
    """A pspec entry (an axis, a tuple of axes or None) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclass
class ShardCtx:
    """Ambient sharding context threaded through model code.

    ``mesh is None`` -> single-device mode: all constraints are no-ops.
    The mesh is a ``distributed.collectives.Mesh``."""
    mesh: Optional[Any]
    rules: Dict[str, Any] = field(default_factory=dict)
    profile: Optional[ShardingProfile] = None

    def pspec(self, *logical: Optional[str]) -> Tuple[Any, ...]:
        return logical_to_pspec(tuple(logical), self.rules)

    def axis(self, logical: str) -> Optional[str]:
        """The mesh axis ``logical`` maps to where it splits a tensor (a
        mesh axis of size > 1), else None."""
        if self.mesh is None:
            return None
        ax = self.rules.get(logical)
        if ax is None or isinstance(ax, (tuple, list)) \
                or self.mesh.size(ax) == 1:
            return None
        return ax

    def shards(self, entry) -> int:
        """How many pieces a pspec entry cuts its dim into."""
        n = 1
        for ax in entry_axes(entry):
            n *= self.mesh.size(ax)
        return n


_LOCAL = threading.local()


def set_ctx(ctx: Optional[ShardCtx]) -> None:
    _LOCAL.ctx = ctx


def current_ctx() -> Optional[ShardCtx]:
    return getattr(_LOCAL, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    prev = current_ctx()
    set_ctx(ctx)
    try:
        yield ctx
    finally:
        set_ctx(prev)


def mesh_ctx() -> Optional[ShardCtx]:
    """The ambient context where it holds a mesh of more than one rank,
    else None: the model code's one test for "sharded"."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or ctx.mesh.world == 1:
        return None
    return ctx


def constrain(x: torch.Tensor, *logical: Optional[str],
              full: Optional[Sequence[Optional[int]]] = None
              ) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` by logical axes, as a check.

    Moves nothing: the model code has already placed ``x``. Without a
    mesh it returns ``x``. Under one, ``x`` must have one dim a logical
    axis, and where ``full`` gives a dim's full size (``None`` skips it),
    the local dim must be that size over the number of shards the rule
    cuts it into."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"constrain: {x.dim()}-dim tensor, {len(logical)} "
                         f"logical axes {logical}")
    spec = ctx.pspec(*logical)
    for i, n in enumerate(full or ()):
        if n is None:
            continue
        parts = ctx.shards(spec[i]) if i < len(spec) else 1
        if n % parts or x.shape[i] != n // parts:
            raise ValueError(
                f"constrain: dim {i} ({logical[i]} -> "
                f"{spec[i] if i < len(spec) else None}) holds "
                f"{x.shape[i]}, the rule's shard of {n} is {n // parts} "
                f"({parts} shards)")
    return x


def tree_pspecs(spec_tree):
    """Map a tree of logical-axis tuples (nested dicts, lists, or a
    ``TrainState``'s ``params``/``opt``) to pspecs via the ambient context
    (the empty pspec everywhere when there is no context)."""
    ctx = current_ctx()
    rules = ctx.rules if ctx is not None else {}

    def walk(node):
        if isinstance(node, tuple):
            return logical_to_pspec(node, rules)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if hasattr(node, "params") and hasattr(node, "opt"):
            return type(node)(params=walk(node.params), opt=walk(node.opt))
        raise TypeError(f"tree_pspecs: unexpected leaf {node!r}")

    return walk(spec_tree)


def shard_slices(shape: Sequence[int], pspec: Tuple[Any, ...],
                 mesh) -> Tuple[slice, ...]:
    """This rank's piece of a tensor of ``shape`` under ``pspec``: one
    slice a dim. A dim cut over axes (a, b) is in a-major order, as JAX
    lays out a ``P(("pod", "data"))`` dim."""
    out = []
    for i, n in enumerate(shape):
        axes = entry_axes(pspec[i]) if i < len(pspec) else ()
        parts, index = 1, 0
        for ax in axes:
            parts *= mesh.size(ax)
            index = index * mesh.size(ax) + mesh.index(ax)
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"into {parts} shards over {axes}")
        step = n // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def local_shape(shape: Sequence[int], pspec: Tuple[Any, ...],
                mesh) -> Tuple[int, ...]:
    """The shape of this rank's piece of a tensor of ``shape`` under
    ``pspec`` (``shard_slices``'s)."""
    return tuple(sl.stop - sl.start for sl in shard_slices(shape, pspec,
                                                          mesh))
