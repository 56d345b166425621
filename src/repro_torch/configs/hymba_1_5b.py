"""hymba-1.5b — parallel attn+mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention heads use a sliding window (Hymba uses SWA in all but 3 layers;
we use SWA uniformly), making long_500k decode sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, FAMILY_HYBRID

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=FAMILY_HYBRID,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    ssm=SSMConfig(state_size=16, head_dim=64, expand=2, chunk_size=256),
    attn_window=1024,
    source="arXiv:2411.13676",
)
