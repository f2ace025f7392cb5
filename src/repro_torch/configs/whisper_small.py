"""whisper-small — encoder-decoder speech model; the conv + mel frontend
is stubbed: the encoder takes precomputed frame embeddings of shape (B,
1500, d_model) as ``batch["audio"]``. [arXiv:2212.04356] Robust Speech
Recognition via Large-Scale Weak Supervision.

12 encoder + 12 decoder layers, d_model=768, 12 heads (kv=12, head_dim
64), d_ff=3072 (plain GELU MLP), vocab 51865, layernorm, learned
positions; every decoder layer has a cross-attention sublayer over the
encoder's output.
"""
from repro_torch.configs import LayerSpec, ModelConfig, _pattern, reduce_config


def make_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,                      # decoder layers
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51_865,
        layers=_pattern([LayerSpec(mixer="attn", cross_attn=True)], 12),
        encoder_layers=12,
        encoder_seq=1500,                   # mel frames after conv stride 2
        pos_emb="learned",
        max_seq_len=65_536,                 # the learned-position table
        norm="layernorm",
        act="gelu",
        gated_mlp=False,
        tie_embeddings=True,
        citation="arXiv:2212.04356",
    )


def make_reduced() -> ModelConfig:
    return reduce_config(make_config())
