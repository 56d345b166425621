"""Learned prefetch subsystem: the JAX package's ``repro.prefetch``,
copied (it is numpy and Python; no module here touches the device).

Replaces the paper's fixed-margin proactive-caching scheme
(``core.proactive.PrestageScheduler``) with a learned, cost-aware
readahead planner, selected by ``AionConfig.prefetch_backend``:

* ``model``   — online lateness model: per key-class empirical-CDF fits
  (the same ``core.staleness.empirical_cdf`` machinery predictive
  cleanup uses) predict each window's re-execution probability, plus an
  online staging-cost/bandwidth estimate that keeps the
  ``StagingCostModel`` interface the engine observes through.
* ``planner`` — segment-granular readahead: maps predicted
  re-executions to the *log segments* holding their records
  (``LogBlockStore.segments_for``) and schedules sequential segment
  sweeps against a bandwidth-vs-deadline-slack cost model, picking
  coalescing candidates (scattered windows worth rewriting into one
  contiguous run) along the way.
* ``scheduler`` — ``LearnedPrestageScheduler``: the drop-in
  ``PrestageScheduler``-shaped front the engine talks to.

The fixed-margin path stays the default (``prefetch_backend="fixed"``)
and the differential-testing baseline.
"""
from repro_torch.prefetch.model import LatenessModel, LearnedCostModel
from repro_torch.prefetch.planner import (
    PlanResult, SegmentPrefetchPlanner, SegmentSweep,
)
from repro_torch.prefetch.scheduler import LearnedPrestageScheduler

__all__ = [
    "LatenessModel", "LearnedCostModel",
    "SegmentPrefetchPlanner", "SegmentSweep", "PlanResult",
    "LearnedPrestageScheduler",
]
