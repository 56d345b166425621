"""On the card (marked ``gpu``; each test skips where no card is found):
the training cell's comparison at its own size with the control failing
it, and a traced run of each cell at its widths with two layers, correct,
its shares of the rooflines and of the peak under 100%. Run them on the
machine with the card: ``python -m pytest -m gpu bench/tests``."""
import json
import time

import pytest
import torch

from bench import compare, harness, program
from bench.tests.small import CELLS

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    program.build_kernels()
    return torch.device("cuda")


def _cut(cell, layers):
    """The cell's files at their widths, with ``layers`` layers."""
    root = harness.ROOT / "bench"
    config = json.loads((root / "configs" /
                         f"{cell.rsplit('.', 1)[0]}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{cell}.json").read_text())
    config["model"]["num_layers"] = layers
    return harness.load_spec(), config, traffic


@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" in c])
def test_training_comparison_and_its_control_at_the_cells_size(cell):
    """The program's first steps within every limit, the fp8 control
    beyond one, at the cell's own size (as ``calibrate.py`` reads them)."""
    from bench import calibrate
    dev = _card()
    found = harness.resolve(harness.load_spec(), cell)
    line = calibrate.train_line(found, 2 ** 31 + 77, True, False, dev)
    limits = found["traffic"]["limits"]
    assert compare.all_within(compare.held(line["program"], limits))
    assert not compare.all_within(compare.held(line["control"], limits))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_shares_under_100(cell):
    _card()
    spec, config, traffic = _cut(cell, 2)
    res = harness.run_cell(spec, cell, seed=11, seconds=2, trace=True,
                           device="cuda", t0=time.perf_counter(),
                           config=config, traffic=traffic)
    assert res["correct"], res["checks"]
    for name, m in res["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
