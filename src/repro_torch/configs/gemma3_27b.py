"""gemma3-27b — dense decoder with 5:1 local:global attention mix, 128k
context. [hf:google/gemma-3-1b-pt model card / Gemma 3 technical report]

62 layers, d_model=5376, 32 heads (GQA kv=16, head_dim 128), d_ff=21504
(GeGLU), vocab 262144, local window 1024. As in the reference's config,
no logit softcap is set (``logit_softcap`` stays 0).
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config

_PATTERN = [
    LayerSpec(mixer="attn_local"),
    LayerSpec(mixer="attn_local"),
    LayerSpec(mixer="attn_local"),
    LayerSpec(mixer="attn_local"),
    LayerSpec(mixer="attn_local"),
    LayerSpec(mixer="attn"),
]


def make_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21_504,
        vocab_size=262_144,
        layers=_pattern(_PATTERN, 62),
        sliding_window=1024,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        citation="hf:google/gemma-3-1b-pt",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
