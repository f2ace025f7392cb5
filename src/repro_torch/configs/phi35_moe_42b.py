"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.
[hf:microsoft/Phi-3.5-MoE-instruct model card]

32 layers, d_model=4096, 32 heads (GQA kv=8, head_dim 128), 16 experts
top-2 with expert d_ff=6400 (SwiGLU), vocab 32064.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config


def make_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32_064,
        layers=_pattern([LayerSpec(mixer="attn", ffn="moe")], 32),
        num_experts=16,
        top_k=2,
        moe_d_ff=6400,
        capacity_factor=1.25,
        norm="layernorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        citation="hf:microsoft/Phi-3.5-MoE-instruct",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
