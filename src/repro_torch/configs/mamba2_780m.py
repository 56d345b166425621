"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, FAMILY_SSM

CONFIG = ModelConfig(
    name="mamba2-780m",
    family=FAMILY_SSM,
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                      # attn-free mamba2 block has no separate FFN
    vocab_size=50_280,
    ssm=SSMConfig(state_size=128, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
