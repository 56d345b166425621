"""Segment-granular readahead planning against a bandwidth/slack cost
model.

The fixed scheme issues one point readahead per upcoming window — on the
log store that is a per-record seek/read sweep whose records may be
scattered over many segments. The planner instead:

1. maps every prefetch-worthy window's storage-resident blocks to the
   log segments holding their live records (``store.segments_for`` —
   the index query, no payload reads),
2. merges records across windows into per-segment **sweeps** (one
   contiguous byte-range read per segment), and
3. schedules sweeps earliest-deadline-first against a cost model:
   a sweep is issued when its estimated read time
   (``span_bytes / bandwidth``, from ``LearnedCostModel``) no longer
   comfortably fits in the slack before its earliest staging deadline —
   prefetching at the *latest responsible moment* keeps the bounded
   read cache from churning on data whose deadline is far out — capped
   by a per-round byte budget (defaulting to the cache budget itself:
   issuing more than the cache holds just evicts our own prefetches).

It also nominates **coalescing** candidates: windows likely to
re-execute whose records are scattered (multiple segments, or a sparse
span within one segment) get rewritten into one contiguous run
(``store.coalesce_windows``), so the *next* re-stage is a single dense
sequential read. Selectivity is what keeps write amplification bounded:
only predicted-hot, actually-scattered windows are rewritten, once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.core.windows import WindowId

# issue a sweep once its deadline is within `safety x` its estimated
# read time (late enough to spare the cache, early enough to finish)
_SLACK_SAFETY = 4.0
# a single-segment window counts as scattered when the byte span its
# records cover exceeds this multiple of the records' own bytes
_SCATTER_SPAN_RATIO = 1.5


@dataclass
class SegmentSweep:
    """One contiguous readahead over a single log segment."""
    sid: int
    keys: List[Tuple[Tuple[float, float], int]]    # BlockKeys
    span_bytes: int
    record_bytes: int
    deadline: float                # earliest stage_at among contributors
    windows: Set[WindowId] = field(default_factory=set)


@dataclass
class PlanResult:
    sweeps: List[SegmentSweep]                 # issue now, EDF order
    deferred_windows: Set[WindowId]            # replan next drive
    coalesce: List[WindowId]                   # rewrite contiguously


class SegmentPrefetchPlanner:
    """Maps predicted re-executions to segment sweeps and coalescing
    work. Stateless across windows except for the coalesce-once set."""

    def __init__(self, cost, *, budget_bytes: int = 16 << 20,
                 coalesce: bool = True,
                 coalesce_probability: float = 0.25,
                 slack_safety: float = _SLACK_SAFETY):
        self.cost = cost
        self.budget_bytes = max(int(budget_bytes), 1)
        self.coalesce = coalesce
        self.coalesce_probability = coalesce_probability
        self.slack_safety = slack_safety
        self._coalesced: Set[WindowId] = set()
        self.stats = {
            "sweeps_planned": 0, "sweeps_issued": 0, "sweeps_deferred": 0,
            "sweep_bytes_issued": 0, "coalesce_requests": 0,
        }

    def forget(self, window: WindowId) -> None:
        self._coalesced.discard(window)

    # ---------------------------------------------------------------- plan
    def plan(self, store,
             wants: Sequence[Tuple[WindowId, float, list, float]],
             now: float) -> PlanResult:
        """``wants``: (window, stage_at, storage block keys, p_reexec)
        rows for every prefetch-worthy window. Returns the sweeps to
        issue now, the windows to re-plan later, and the coalescing
        candidates."""
        key_meta: Dict[Tuple, Tuple[WindowId, float]] = {}
        all_keys = []
        for wid, stage_at, keys, _p in wants:
            for k in keys:
                key_meta[(tuple(k[0]), int(k[1]))] = (wid, stage_at)
                all_keys.append(k)
        placement = store.segments_for(all_keys)

        sweeps: List[SegmentSweep] = []
        for sid, items in placement.items():
            lo = min(off for _, off, _ in items)
            hi = max(off + length for _, off, length in items)
            sweep = SegmentSweep(
                sid=sid, keys=[k for k, _, _ in items],
                span_bytes=hi - lo,
                record_bytes=sum(length for _, _, length in items),
                deadline=float("inf"))
            for k, _, _ in items:
                meta = key_meta.get((tuple(k[0]), int(k[1])))
                if meta is not None:
                    sweep.windows.add(meta[0])
                    sweep.deadline = min(sweep.deadline, meta[1])
            sweeps.append(sweep)
        self.stats["sweeps_planned"] += len(sweeps)

        # EDF + cost model: a sweep waits while its deadline slack still
        # comfortably exceeds its estimated read time; the byte budget
        # caps one round's cache pressure
        sweeps.sort(key=lambda s: s.deadline)
        issue: List[SegmentSweep] = []
        deferred: Set[WindowId] = set()
        spent = 0
        for sw in sweeps:
            est_read = self.cost.delta_t_bytes(sw.span_bytes)
            slack = sw.deadline - now
            if slack > self.slack_safety * max(est_read, 1e-6) \
                    and spent + sw.span_bytes > self.budget_bytes:
                # far-out AND over budget: wait for a later drive
                self.stats["sweeps_deferred"] += 1
                deferred |= sw.windows
                continue
            if spent + sw.span_bytes > self.budget_bytes and issue:
                self.stats["sweeps_deferred"] += 1
                deferred |= sw.windows
                continue
            issue.append(sw)
            spent += sw.span_bytes
        self.stats["sweeps_issued"] += len(issue)
        self.stats["sweep_bytes_issued"] += spent
        issued_windows = set().union(*(s.windows for s in issue)) \
            if issue else set()
        deferred -= issued_windows

        coalesce = self._pick_coalesce(store, wants) if self.coalesce \
            else []
        return PlanResult(sweeps=issue, deferred_windows=deferred,
                          coalesce=coalesce)

    # ------------------------------------------------------------ coalesce
    def _pick_coalesce(self, store, wants) -> List[WindowId]:
        out: List[WindowId] = []
        for wid, _stage_at, keys, p in wants:
            # one wanted key is enough: window_scatter counts ALL of the
            # window's live storage records (m- and p-bucket spills), so
            # the authoritative scatter check below is what gates the
            # rewrite, not how many p-blocks this round wants
            if p < self.coalesce_probability or wid in self._coalesced \
                    or not keys:
                continue
            wk = tuple(keys[0][0])
            records, segments, span, rec_bytes = store.window_scatter(wk)
            if records < 2:
                continue
            scattered = segments > 1 or (
                rec_bytes > 0 and span > _SCATTER_SPAN_RATIO * rec_bytes)
            if scattered:
                self._coalesced.add(wid)
                self.stats["coalesce_requests"] += 1
                out.append(wid)
        return out
