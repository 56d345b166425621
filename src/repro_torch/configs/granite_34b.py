"""granite-34b — llama-arch code model, MQA [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, FAMILY_DENSE

CONFIG = ModelConfig(
    name="granite-34b",
    family=FAMILY_DENSE,
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    mlp_variant="gelu",          # GPTBigCode-style 2-matrix MLP
    source="arXiv:2405.04324",
)
