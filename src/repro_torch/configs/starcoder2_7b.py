"""starcoder2-7b — GQA, RoPE [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, FAMILY_DENSE

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family=FAMILY_DENSE,
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    mlp_variant="gelu",          # starcoder2 uses a 2-matrix GELU MLP
    use_bias=True,               # starcoder2 keeps biases
    source="arXiv:2402.19173",
)
