"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596].

12L d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096 vocab=256206. The audio
frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings consumed by the encoder.
"""
from repro_torch.configs.base import ModelConfig, FAMILY_AUDIO

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family=FAMILY_AUDIO,
    num_layers=12,               # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    frontend_tokens=1024,        # precomputed audio frame embeddings (stub)
    source="arXiv:2308.11596",
)
