"""The port's four examples (``examples/torch_*.py``) run to their end on
the CPU (``main(device="cpu")``) and print the JAX examples' lines; none
of them imports JAX, the JAX package or ``benchmarks``.

Where a line is deterministic it is held to the JAX example's: the
serving example's completions and page moves and the cleanup demo's
bounds against the JAX example run in the same test; the quickstart's
late events, executions and amended window averages (the I/O thread's
timing moves its byte and block counts) and the staleness trigger's
``deltat`` and ``deltaev`` columns and the counts of executions a bound
needs against the JAX examples' figures (their runs take 14 s and most
of a minute on the CPU). The port's own descent places the aion column
(``tests/test_torch_staleness.py``).
The training example's weights come from torch's generator, so only the
form of its lines is held.
"""
import ast
import re
import runpy
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["torch_quickstart.py", "torch_late_event_stream.py",
            "torch_serve_lm.py", "torch_train_lm.py"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    return runpy.run_path(str(ROOT / "examples" / name), run_name="example")


def _lines(out, pattern):
    return [m.groups() for m in re.finditer(pattern, out, re.M)]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_the_reference(name):
    tree = ast.parse((ROOT / "examples" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, name
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots


#: ``examples/quickstart.py``'s deterministic figures
QUICKSTART_STEPS = [("80.0", "4", "0"), ("140.0", "5", "4483"),
                    ("200.0", "5", "8986"), ("260.0", "5", "13509")]
QUICKSTART_EXECUTIONS = [("60", "41", "55")]
QUICKSTART_WINDOWS = [("0", "20", "458.36"), ("20", "40", "623.25"),
                      ("40", "60", "351.80")]


def test_quickstart_prints_the_jax_lines(capsys):
    engine = _load("torch_quickstart.py")["main"](device="cpu")
    out = capsys.readouterr().out
    assert engine.device.type == "cpu"
    steps = r"^t=\s*([\d.]+)s  windows=\s*(\d+) device=\s*[\d.]+MB " \
        r"host=\s*[\d.]+MB late_events=(\d+)$"
    assert _lines(out, steps) == QUICKSTART_STEPS
    execs = r"^executions: live=(\d+) late=(\d+) purged=(\d+)$"
    assert _lines(out, execs) == QUICKSTART_EXECUTIONS
    assert int(_lines(out, execs)[0][1]) > 0
    assert _lines(out, r"^io: (\d+) staged / (\d+) destaged blocks, "
                       r"(\d+) destage preemptions$")
    wins = r"^window \[(\d+),(\d+)\): avg=([-\d.]+)$"
    assert _lines(out, wins) == QUICKSTART_WINDOWS


def test_late_event_stream_prints_the_jax_lines(capsys):
    jmod = _load("late_event_stream.py")
    jmod["cleanup_demo"]()
    jout = capsys.readouterr().out
    _load("torch_late_event_stream.py")["main"](device="cpu")
    out = capsys.readouterr().out
    bound = r"^  after\s+(\d+) observations: bound =\s+([\d.]+)s"
    assert len(_lines(out, bound)) == 3
    assert _lines(out, bound) == _lines(jout, bound)
    table = r"^\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)$"
    rows = _lines(out, table)
    assert [(k, d, e) for k, _, d, e in rows] == [
        ("4", "0.2364", "0.2255"), ("8", "0.1025", "0.1052"),
        ("16", "0.0365", "0.0479")]
    assert all(float(a) < float(d) for _, a, d, _ in rows)
    needs = r"^  bound ([\d.]+): aion needs K=(\d+), deltat K=(\d+), " \
        r"deltaev K=(\d+)$"
    assert _lines(out, needs) == [("0.1", "3", "9", "9"),
                                  ("0.05", "4", "14", "16"),
                                  ("0.01", "7", "32", "59")]
    stall = r"^  (aion-full|no-pre-stgng)\s+fetch_stall=([\d.]+)s " \
        r"late_execs=(\d+)$"
    assert [v for v, _, _ in _lines(out, stall)] == ["aion-full",
                                                     "no-pre-stgng"]


def test_serve_lm_prints_the_jax_lines(capsys):
    _load("serve_lm.py")["main"]()
    jout = capsys.readouterr().out
    sched = _load("torch_serve_lm.py")["main"](device="cpu")
    out = capsys.readouterr().out
    assert sched.cache.device.type == "cpu"
    done = r"^completed (\d+)/(\d+) requests, (\d+) tokens in"
    assert _lines(out, done) == _lines(jout, done) == [("8", "8", "192")]
    tier = r"^tiering: (.*)$"
    assert _lines(out, tier) == _lines(jout, tier)


def test_train_lm_prints_the_jax_lines(capsys, tmp_path):
    losses = _load("torch_train_lm.py")["main"](
        ["--steps", "4", "--dmodel", "64", "--layers", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path)], device="cpu")
    out = capsys.readouterr().out
    assert re.search(r"^training [\d.]+M params, 4 steps of 8x32 tokens$",
                     out, re.M)
    last = _lines(out, r"^loss: ([\d.]+) -> ([\d.]+) \(random = 9\.011\) "
                       r"in \d+s; checkpoints in (.*)$")
    assert last == [(f"{losses[0]:.3f}", f"{losses[-1]:.3f}",
                     str(tmp_path))]
    assert len(losses) == 4
