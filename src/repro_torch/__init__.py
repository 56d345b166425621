"""PyTorch/CUDA port of the Aion streaming engine (``src/repro``).

Laid out module for module like the JAX package, which stays the
reference this package is tested against. It imports torch, numpy and the
standard library only — never JAX, and nothing of ``repro``. Entry points
run on the card unless the caller passes another ``device``.
"""
