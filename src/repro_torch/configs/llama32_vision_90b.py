"""llama-3.2-vision-90b — dense decoder with interleaved cross-attention
image layers (1 cross per 4 self). The ViT vision encoder and projector
are stubbed: the model takes projected patch embeddings of shape (B,
num_media_tokens, d_model) as ``batch["media"]``.
[hf:meta-llama/Llama-3.2-11B-Vision model card, scaled to 90B]

100 layers (80 self + 20 cross-only), d_model=8192, 64 heads (GQA kv=8,
head_dim 128), d_ff=28672 (SwiGLU), vocab 128256, untied embeddings.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config

_PATTERN = [
    LayerSpec(mixer="attn"),
    LayerSpec(mixer="attn"),
    LayerSpec(mixer="attn"),
    LayerSpec(mixer="attn"),
    LayerSpec(mixer="none", cross_attn=True),  # pure cross-attn block
]


def make_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        vocab_size=128_256,
        layers=_pattern(_PATTERN, 100),
        rope_theta=500_000.0,
        num_media_tokens=1601,   # 1 tile of 1600 patches + CLS, projected
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        citation="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
