"""smollm-360m — llama-architecture small dense model.
[hf:HuggingFaceTB/SmolLM-135M model card family]

32 layers, d_model=960, 15 heads (GQA kv=5, head_dim 64), d_ff=2560
(SwiGLU), vocab 49152, RMSNorm, RoPE; bf16 parameters.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config


def make_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49_152,
        layers=_pattern([LayerSpec(mixer="attn")], 32),
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        citation="hf:HuggingFaceTB/SmolLM-135M",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
