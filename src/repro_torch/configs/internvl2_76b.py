"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The InternViT
frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (``frontend_tokens`` positions of d_model).
"""
from repro_torch.configs.base import ModelConfig, FAMILY_VLM

CONFIG = ModelConfig(
    name="internvl2-76b",
    family=FAMILY_VLM,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    frontend_tokens=256,         # one image tile = 256 patch embeddings
    source="arXiv:2404.16821",
)
