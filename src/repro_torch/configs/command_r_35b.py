"""command-r-35b — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, FAMILY_DENSE

CONFIG = ModelConfig(
    name="command-r-35b",
    family=FAMILY_DENSE,
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    tie_embeddings=True,         # command-r ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-v01",
)
