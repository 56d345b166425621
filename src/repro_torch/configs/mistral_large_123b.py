"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig, FAMILY_DENSE

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family=FAMILY_DENSE,
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=32_768,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
