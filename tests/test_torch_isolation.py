"""The port stands alone: ``repro_torch`` and every submodule import with
JAX blocked, and no module of the port imports JAX or anything of the
JAX package (``repro``)."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

PKG_DIR = Path(repro_torch.__file__).resolve().parent

#: modules each slice of the port added; the walk below must reach them
SLICE_MODULES = [
    "repro_torch.core.engine", "repro_torch.kernels.segment_aggregate",
    "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ref",
    "repro_torch.kernels.ops", "repro_torch.configs",
    "repro_torch.configs.base", "repro_torch.configs.starcoder2_7b",
    "repro_torch.configs.hymba_1_5b", "repro_torch.serve",
    "repro_torch.serve.kvcache", "repro_torch.serve.scheduler",
    "repro_torch.convert", "repro_torch.kernels.flash_attention_bwd",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.transformer",
    "repro_torch.models.model", "repro_torch.train",
    "repro_torch.train.optimizer", "repro_torch.train.train_step",
    "repro_torch.train.checkpoint", "repro_torch.data.pipeline",
    "repro_torch.distributed", "repro_torch.distributed.fault",
    "repro_torch.launch", "repro_torch.launch.train",
    "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
    "repro_torch.configs.mamba2_780m", "repro_torch.serve.serve_step",
    "repro_torch.launch.serve", "repro_torch.kernels.flash_tiles",
    "repro_torch.kernels.flash_limits", "repro_torch.core.pipeline",
    "repro_torch.prefetch", "repro_torch.prefetch.model",
    "repro_torch.prefetch.planner", "repro_torch.prefetch.scheduler",
    "repro_torch.testing", "repro_torch.testing.faults",
]

#: classes each slice added to a module the walk imports: (module, name)
SLICE_CLASSES = [
    ("repro_torch.distributed", "HeartbeatMonitor"),
    ("repro_torch.distributed", "EngineRecovery"),
    ("repro_torch.distributed", "BackupExecutor"),
    ("repro_torch.distributed", "RestartManager"),
    ("repro_torch.testing", "FaultInjector"),
    ("repro_torch.testing", "FaultyBlockStore"),
]


def _modules():
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages([str(PKG_DIR)],
                                              prefix="repro_torch."))


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(PKG_DIR.parent)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PKG_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG_DIR)))
def test_no_jax_or_reference_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_slice_modules_are_checked(name):
    """Every module of the ported slices is among those the two checks
    above import and parse."""
    assert name in _modules()


@pytest.mark.parametrize("module,name", SLICE_CLASSES,
                         ids=lambda x: x if isinstance(x, str) else "")
def test_slice_classes_are_exported(module, name):
    """The classes of the ported slices are exported where the walk above
    imports them with JAX blocked, and defined in the port."""
    import importlib
    assert module in _modules()
    obj = getattr(importlib.import_module(module), name)
    assert obj.__module__.startswith("repro_torch.")
