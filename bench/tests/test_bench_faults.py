"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped (a small cell on the CPU), the rest
of the run as the benchmark drives it, under each fault the cell can
have (one chip: no exchange between chips to leave out)."""
import time

import pytest

from bench import faults, harness
from bench.tests.small import CELLS, small

TRAIN = tuple(c for c in CELLS if ".train" in c)
SERVE = tuple(c for c in CELLS if ".serve" in c)


def run(cell, seed=2 ** 31 + 5):
    spec, config, traffic = small(cell)
    return harness.run_cell(spec, cell, seed=seed, seconds=0.2, trace=False,
                            device="cpu", t0=time.perf_counter(),
                            config=config, traffic=traffic)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN
                                        for f in ("unchanged",
                                                  "half_batch")])
def test_a_broken_training_step_is_caught(cell, fault):
    with faults.FAULTS[fault]():
        res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_token_is_caught(cell):
    _, config, _ = small(cell)
    with faults.token_altered(config["model"]["vocab_size"]):
        res = run(cell)
    assert not res["correct"], res["checks"]
