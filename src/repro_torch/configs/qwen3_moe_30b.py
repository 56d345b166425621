"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per-expert) vocab=151936,
MoE 128e top-8. head_dim=128 per the model card (q/k project above d_model).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, FAMILY_MOE

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=FAMILY_MOE,
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8),
    source="hf:Qwen/Qwen3-30B-A3B",
)
