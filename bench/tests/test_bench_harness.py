"""The harness finds its cells, configurations, traffic mixes, drivers and
metrics by name, refuses what it does not know, takes a new item as new
files, and prints the contract's line."""
import json
import re
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from bench import harness
from bench.tests.small import CELLS, small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            # every listed cell reports the end-to-end metric it moves
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
    for w in cells:
        reported = harness.metrics_for(spec, w, trace=False)
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert harness.metrics_for(spec, w, trace=True)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves_by_name(cell):
    spec = harness.load_spec()
    found = harness.resolve(spec, cell)
    assert found["cell"]["name"] == cell
    assert found["traffic"]["driver"] in ("train", "serve")
    assert callable(found["driver"].run)
    for m in harness.metrics_for(spec, cell, True) + harness.metrics_for(
            spec, cell, False):
        assert (harness.ROOT / "bench" / "metrics" /
                f"{m['name']}.py").is_file()


@pytest.mark.parametrize("what", ["workload", "config", "family", "traffic",
                                  "driver", "metric"])
def test_unknown_names_are_refused(what, tmp_path):
    root = _copy_tree(tmp_path)
    spec = harness.load_spec(root)
    cell = spec["workloads"][0]["name"]
    if what == "workload":
        cell = "no-such-cell"
    elif what == "config":
        spec["workloads"][0]["config"] = "no-such-config"
    elif what == "family":
        c = spec["configs"][0]
        path = root / c["file"]
        config = json.loads(path.read_text())
        config["model"]["family"] = "no_such_family"
        path.write_text(json.dumps(config))
        cell = next(w["name"] for w in spec["workloads"]
                    if w["config"] == c["name"])
    elif what == "traffic":
        spec["workloads"][0]["traffic"] = "no-such-traffic"
    elif what == "driver":
        name = spec["workloads"][0]["traffic"]
        path = root / "bench" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t["driver"] = "no-such-driver"
        path.write_text(json.dumps(t))
    with pytest.raises(harness.UnknownName):
        if what == "metric":
            harness.read_metrics([{"name": "no-such-metric", "unit": "s"}],
                                 {}, root)
        else:
            harness.resolve(spec, cell, root)


def _copy_tree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as
    files and entries, with no file of the harness edited, run."""
    root = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    _, config, traffic = small("starcoder2-7b.train-4k")
    config = dict(config, name="dummy-lm")
    (root / "bench" / "configs" / "dummy-lm.json").write_text(
        json.dumps(config))
    (root / "bench" / "traffic" / "dummy-lm.train-tiny.json").write_text(
        json.dumps(traffic))
    (root / "bench" / "metrics" / "steps_done.train.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    spec["configs"].append({"name": "dummy-lm", "source": "none",
                            "file": "bench/configs/dummy-lm.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy-lm.train-tiny",
                              "config": "dummy-lm",
                              "traffic": "dummy-lm.train-tiny", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "steps_done.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "model",
                              "moves": "train_tokens_per_s",
                              "workloads": ["dummy-lm.train-tiny"]})
    spec["end_to_end"][0]["workloads"].append("dummy-lm.train-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = harness.run_cell(spec, "dummy-lm.train-tiny", seed=5, seconds=0.2,
                           trace=True, device="cpu", t0=time.perf_counter(),
                           root=root)
    assert res["metrics"]["steps_done.train"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data


NEW_FAMILY = textwrap.dedent("""
    import json, sys, time
    sys.path[:0] = [{root!r}, {src!r}]
    from bench import harness
    from bench.reference import family
    spec = harness.load_spec()
    res = harness.run_cell(spec, "toy-ssm.train-tiny", seed=7, seconds=0.2,
                           trace=False, device="cpu", t0=time.perf_counter())
    config = harness.resolve(spec, "toy-ssm.train-tiny")["config"]
    print(json.dumps({{"correct": res["correct"], "checks": res["checks"],
                      "reference": family(config["model"]).__file__}}))
""")


def test_a_new_block_family_is_new_files_only(tmp_path):
    """A family no cell has (the port's ``ssm``): its reference as
    ``bench/reference/ssm.py``, with its own leaves and ways of drawing
    them, a configuration, a traffic mix and an entry, with no file of the
    harness edited, runs from that checkout against the port and is
    correct (float32 compute, so both sides agree to rounding)."""
    root = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    shutil.copy(harness.ROOT / "bench" / "tests" / "ssm_family.py",
                root / "bench" / "reference" / "ssm.py")
    model = {"name": "toy-ssm", "family": "ssm", "num_layers": 2,
             "d_model": 128, "num_heads": 0, "num_kv_heads": 0,
             "head_dim": 0, "d_ff": 0, "vocab_size": 500,
             "mlp_variant": "gelu", "use_bias": False,
             "tie_embeddings": False, "norm_eps": 1e-5,
             "param_dtype": "float32", "compute_dtype": "float32",
             "remat": "none",
             "ssm": {"state_size": 16, "head_dim": 32, "expand": 2,
                     "chunk_size": 32, "conv_width": 4}}
    (root / "bench" / "configs" / "toy-ssm.json").write_text(
        json.dumps({"name": "toy-ssm", "model": model}))
    _, _, traffic = small("starcoder2-7b.train-4k")
    (root / "bench" / "traffic" / "toy-ssm.train-tiny.json").write_text(
        json.dumps(traffic))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-ssm", "source": "none",
                            "file": "bench/configs/toy-ssm.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy-ssm.train-tiny",
                              "config": "toy-ssm",
                              "traffic": "toy-ssm.train-tiny", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("toy-ssm.train-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = NEW_FAMILY.format(root=str(root),
                             src=str(harness.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["reference"] == str(root / "bench" / "reference" / "ssm.py")
    assert got["correct"], got["checks"]
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("cell,trace", [(c, t) for c in CELLS
                                        for t in (False, True)])
def test_the_last_line_has_the_contracts_keys(cell, trace):
    spec, config, traffic = small(cell)
    res = harness.run_cell(spec, cell, seed=2 ** 31 + 11, seconds=0.2,
                           trace=trace, device="cpu",
                           t0=time.perf_counter(), config=config,
                           traffic=traffic)
    line, notes = harness.finish(res)
    out = json.loads(line)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(out) == keys + ["checks"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    wanted = {m["name"] for m in harness.metrics_for(spec, cell, trace)}
    # on the CPU no device op runs, so a share of a roofline may read 0
    assert set(out["metrics"]) <= wanted
    e2e = {m["name"] for m in harness.metrics_for(spec, cell, False)}
    if not trace:
        assert set(out["metrics"]) == e2e
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
    assert notes[-len(out["checks"]):] == [
        n for n in notes if n.startswith("check ")]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert "repro_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in harness.forbidden_modules()


def test_percentile_is_over_every_value():
    assert harness.percentile([1.0], 95) == 1.0
    assert harness.percentile(list(map(float, range(101))), 95) == 95.0
    assert harness.percentile([0.0, 10.0], 95) == pytest.approx(9.5)


def test_read_trace_labels_gaps_by_the_open_span():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench:segment",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "bench:decode",
           "ts": 10, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 15, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 70, "dur": 10}]
    r = harness.read_trace(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)
    assert dict(r["device_ops"]) == pytest.approx({"k_a": 30e-6,
                                                   "k_b": 10e-6})
    gaps = dict(r["idle_gaps"])
    assert gaps["decode"] == pytest.approx(45e-6)
    assert gaps["host outside the benchmark's spans"] == pytest.approx(20e-6)
