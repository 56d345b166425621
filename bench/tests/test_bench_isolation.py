"""Nothing the benchmark runs loads JAX or the JAX package: every module
of ``bench/`` and the program's modules it reaches import with ``jax``,
``jaxlib``, ``flax`` and ``repro`` blocked, and after they have, no
loaded module's top-level name (the part before the first dot) is one of
them, compared whole, so that ``repro_torch`` passes and ``repro`` does
not. The plain references import neither the program nor JAX."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

from bench import harness

BENCH = harness.ROOT / "bench"


def bench_modules():
    for p in sorted(BENCH.rglob("*.py")):
        if "tests" not in p.parts:
            yield p


CHILD = textwrap.dedent("""
    import importlib.util, sys
    for name in {blocked!r}:
        sys.modules[name] = None          # an import of it now fails
    sys.path[:0] = [{root!r}, {src!r}]
    for path in {paths!r}:
        spec = importlib.util.spec_from_file_location(
            "m" + str(abs(hash(path))), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    from bench import program
    from bench.tests.small import small
    _, config, traffic = small("starcoder2-7b.train-4k")
    program.build_model(config["model"], "cpu")
    program.train_targets(None)
    program.serve_targets(None)
    program.prefill_step, program.decode_step
    import repro_torch.serve.serve_step, repro_torch.train.train_step
    top = sorted({{m.split(".")[0] for m, v in sys.modules.items()
                  if v is not None}})
    print(",".join(top))
""")


def test_every_module_imports_with_jax_and_repro_blocked():
    code = CHILD.format(blocked=list(harness.FORBIDDEN),
                        root=str(harness.ROOT),
                        src=str(harness.ROOT / "src"),
                        paths=[str(p) for p in bench_modules()])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(
        harness.FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_references_import_nothing_of_the_program():
    """A reference takes from the benchmark only the other references and
    the weights' layout (``bench/weights.py``, which imports no more)."""
    allowed = {"torch", "math", "typing", "importlib", "__future__",
               "bench"}
    refs = sorted((BENCH / "reference").glob("*.py"))
    for p in refs + [BENCH / "weights.py",
                     BENCH / "tests" / "ssm_family.py"]:
        for name in _imports(p):
            assert name.split(".")[0] in allowed, (p.name, name)
            if name.startswith("bench"):
                assert name.startswith(("bench.reference",
                                        "bench.weights")), (p.name, name)


def test_only_program_and_faults_import_the_program():
    """The yardstick (counts, weights, comparisons, references, readers,
    the harness) takes nothing from the program; the drivers reach it
    through ``bench/program.py``."""
    reach = {"program.py", "faults.py"}
    for p in bench_modules():
        if p.name in reach:
            continue
        for name in _imports(p):
            assert name.split(".")[0] != "repro_torch", (p, name)
