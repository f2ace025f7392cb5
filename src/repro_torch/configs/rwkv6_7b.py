"""rwkv6-7b ("Finch") — attention-free RNN with data-dependent decay
(dynamic token-shift + WKV6 recurrence). [arXiv:2404.05892] Eagle and
Finch: RWKV with Matrix-Valued States and Dynamic Recurrence.

32 layers, d_model=4096, attn-free (64 wkv heads of dim 64),
channel-mix d_ff=14336, vocab 65536, layernorm, untied embeddings.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config


def make_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,          # wkv heads = d_model / rwkv_head_dim
        num_kv_heads=64,
        head_dim=64,
        d_ff=14_336,
        vocab_size=65_536,
        layers=_pattern([LayerSpec(mixer="rwkv", ffn="rwkv_cmix")], 32),
        rwkv_head_dim=64,
        pos_emb="none",
        norm="layernorm",
        act="relu2",
        gated_mlp=False,
        tie_embeddings=False,
        citation="arXiv:2404.05892",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
