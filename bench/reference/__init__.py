"""The plain references, one module a block family, found by the
configuration's ``family``: ``bench/reference/<family>.py`` gives
``leaves(cfg)``, one layer's parameters as ``bench/weights.py`` draws
them, and ``layer(cfg, params, x, positions, precision)``; it may give
``RULES``, its own ways of drawing a leaf by name. A later family is a
new file here."""
import importlib


def family(cfg: dict):
    """The reference module of ``cfg["family"]``."""
    name = cfg["family"]
    if not name.isidentifier():
        raise ValueError(f"not a family name: {name!r}")
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise ValueError(f"no reference for the {name!r} family "
                         f"(bench/reference/{name}.py)") from None
