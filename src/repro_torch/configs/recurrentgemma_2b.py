"""recurrentgemma-2b — Griffin-style hybrid: RG-LRU recurrent blocks mixed
with local (sliding-window) attention in a 2:1 ratio ("1:2" attn:recurrent).

[arXiv:2402.19427] Griffin: Mixing Gated Linear Recurrences with Local
Attention for Efficient Language Models; RecurrentGemma model card.
26 layers, d_model=2560, 10 heads (MQA kv=1, head_dim 256), d_ff=7680
(GeGLU), vocab 256000, window 2048, rnn width 2560; bf16 parameters.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config

_PATTERN = [
    LayerSpec(mixer="rglru"),
    LayerSpec(mixer="rglru"),
    LayerSpec(mixer="attn_local"),
]


def make_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        layers=_pattern(_PATTERN, 26),
        sliding_window=2048,
        rnn_width=2560,
        conv_width=4,
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        citation="arXiv:2402.19427",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
