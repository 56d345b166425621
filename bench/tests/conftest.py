"""The benchmark's own tests (``python -m pytest bench/tests`` from the
root of the repository): CPU tests at small sizes, and card-only tests
marked ``gpu`` that skip where no card is found."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Two intra-op threads a test: several workers share the host."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
