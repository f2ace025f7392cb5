"""starcoder2-3b — dense GQA code model with 4k sliding-window attention
and RoPE. [arXiv:2402.19173] StarCoder 2 and The Stack v2.

30 layers, d_model=3072, 24 heads (GQA kv=2, head_dim 128), d_ff=12288
(non-gated GELU MLP), vocab 49152, window 4096, layernorm.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config


def make_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12_288,
        vocab_size=49_152,
        layers=_pattern([LayerSpec(mixer="attn_local")], 30),
        sliding_window=4096,
        rope_theta=100_000.0,
        norm="layernorm",
        act="gelu",
        gated_mlp=False,
        citation="arXiv:2402.19173",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
