"""minitron-8b — width/depth-pruned Nemotron-4. [arXiv:2407.14679]
Compact Language Models via Pruning and Knowledge Distillation.

32 layers, d_model=4096, 32 heads (GQA kv=8, head_dim 128), d_ff=16384
(squared-ReLU non-gated MLP, Nemotron-style), vocab 256000.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config


def make_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16_384,
        vocab_size=256_000,
        layers=_pattern([LayerSpec(mixer="attn")], 32),
        norm="layernorm",
        act="relu2",
        gated_mlp=False,
        tie_embeddings=False,
        citation="arXiv:2407.14679",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
