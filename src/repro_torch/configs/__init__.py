"""Architecture/config registry, copied from the JAX package's
``configs/__init__.py``, with the engine's ``AionConfig`` and the paper's
Table-1 workloads.

``get_config(name)`` returns the full assigned config; ``reduced(cfg)``
derives a same-family smoke-test config (small widths/layers/experts) that
runs one step on CPU; ``applicable_shapes(cfg)`` encodes the cell matrix
(long_500k only for sub-quadratic archs).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs.base import (
    ALL_SHAPES,
    AionConfig,
    LONG_500K,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    MULTI_POD_MESH,
    ShapeConfig,
    SHAPES_BY_NAME,
    SINGLE_POD_MESH,
    SSMConfig,
    to_json,
    FAMILY_AUDIO,
    FAMILY_DENSE,
    FAMILY_ENCDEC,
    FAMILY_HYBRID,
    FAMILY_MOE,
    FAMILY_SSM,
    FAMILY_VLM,
)

from repro_torch.configs.workloads import (
    WORKLOADS, WorkloadConfig, get_workload,
)

from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.command_r_35b import CONFIG as COMMAND_R_35B
from repro_torch.configs.starcoder2_7b import CONFIG as STARCODER2_7B
from repro_torch.configs.internvl2_76b import CONFIG as INTERNVL2_76B
from repro_torch.configs.phi35_moe_42b import CONFIG as PHI35_MOE_42B
from repro_torch.configs.qwen3_moe_30b import CONFIG as QWEN3_MOE_30B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        MAMBA2_780M,
        GRANITE_34B,
        MISTRAL_LARGE_123B,
        COMMAND_R_35B,
        STARCODER2_7B,
        INTERNVL2_76B,
        PHI35_MOE_42B,
        QWEN3_MOE_30B,
        SEAMLESS_M4T_MEDIUM,
        HYMBA_1_5B,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving the family shape
    (GQA ratio, MoE routing, SSM state, enc-dec split, frontends)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=256,
        vocab_size=512,
        d_ff=0 if cfg.d_ff == 0 else 512,
        head_dim=64 if cfg.resolved_head_dim else 0,
        rope_theta=cfg.rope_theta,
        remat="none",
        tie_embeddings=cfg.tie_embeddings,
        family=cfg.family,
        source=cfg.source,
    )
    if cfg.has_attention:
        # keep the GQA group ratio when possible
        ratio = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
        kw["num_heads"] = 4
        kw["num_kv_heads"] = max(4 // min(ratio, 4), 1)
    else:
        kw["num_heads"] = 0
        kw["num_kv_heads"] = 0
    if cfg.moe.enabled:
        kw["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
        )
    if cfg.ssm.enabled:
        kw["ssm"] = SSMConfig(
            state_size=min(cfg.ssm.state_size, 16),
            head_dim=32,
            expand=2,
            chunk_size=32,
        )
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.frontend_tokens:
        kw["frontend_tokens"] = 16
    if cfg.attn_window:
        kw["attn_window"] = 32
    return ModelConfig(**kw)


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """The assignment's cell matrix. long_500k needs sub-quadratic decode;
    skipped for pure full-attention archs (noted in DESIGN.md §5)."""
    shapes = []
    for s in ALL_SHAPES:
        if s.name == LONG_500K.name and not cfg.is_subquadratic:
            continue
        shapes.append(s)
    return shapes


def all_cells() -> List[Tuple[ModelConfig, ShapeConfig]]:
    cells = []
    for name in sorted(ARCHS):
        cfg = ARCHS[name]
        for s in applicable_shapes(cfg):
            cells.append((cfg, s))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    """(arch, shape, reason) for every assigned-but-skipped cell."""
    out = []
    for name in sorted(ARCHS):
        cfg = ARCHS[name]
        for s in ALL_SHAPES:
            if s.name == LONG_500K.name and not cfg.is_subquadratic:
                out.append((name, s.name,
                            "pure full-attention arch: 500k decode is not "
                            "sub-quadratic (DESIGN.md §5)"))
    return out


__all__ = [
    "ARCHS", "get_config", "reduced", "applicable_shapes", "all_cells",
    "skipped_cells", "AionConfig", "MeshConfig", "ModelConfig", "MoEConfig",
    "ShapeConfig", "SSMConfig", "ALL_SHAPES", "SHAPES_BY_NAME",
    "SINGLE_POD_MESH", "MULTI_POD_MESH",
    "FAMILY_AUDIO", "FAMILY_DENSE", "FAMILY_ENCDEC", "FAMILY_HYBRID",
    "FAMILY_MOE", "FAMILY_SSM", "FAMILY_VLM",
    "to_json", "WORKLOADS", "WorkloadConfig", "get_workload",
]
