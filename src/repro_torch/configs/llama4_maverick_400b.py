"""llama4-maverick-400b-a17b — 128-expert top-1 MoE with a shared expert
and chunked/local attention on 3 of 4 layers (long-context native).
Early-fusion multimodality is out of scope for the text backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E model card family]

48 layers, d_model=5120, 40 heads (GQA kv=8, head_dim 128), 128 experts
top-1 + shared expert, expert d_ff=8192 (SwiGLU), vocab 202048.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config

# MoE interleaved 1:1 with dense-FFN layers (as in Maverick); chunked
# (local) attention on 3 of 4 layers, global on the 4th (RoPE on every
# layer, as the reference's config has it).
_PATTERN = [
    LayerSpec(mixer="attn_local", ffn="dense"),
    LayerSpec(mixer="attn_local", ffn="moe"),
    LayerSpec(mixer="attn_local", ffn="dense"),
    LayerSpec(mixer="attn", ffn="moe"),
]


def make_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16_384,              # dense interleaved layers
        vocab_size=202_048,
        layers=_pattern(_PATTERN, 48),
        sliding_window=8192,          # chunked attention
        rope_theta=500_000.0,
        num_experts=128,
        top_k=1,
        moe_d_ff=8192,
        shared_expert=True,
        capacity_factor=1.25,
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
