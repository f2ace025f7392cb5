"""Model configs: the reference package's dataclasses and its registry of
ten architectures — eight decoder-only, the encoder-decoder whisper-small
and the cross-attention VLM llama-3.2-vision-90b.

The dataclasses keep every field of the reference's, so a config built
here and one built there compare field for field; the port's model code
implements the dense-attention, local-attention, RG-LRU and RWKV6
time-mix / channel-mix blocks with dense, MoE and RWKV channel-mix FFNs,
cross-attention sublayers, mixer-less and FFN-less blocks, an encoder
stack and learned positions (``models/transformer.py``).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

MIXERS = ("attn", "attn_local", "rglru", "rwkv", "none")
FFNS = ("dense", "moe", "rwkv_cmix", "none")


@dataclass(frozen=True)
class LayerSpec:
    """One transformer block: a sequence mixer + an FFN."""

    mixer: str = "attn"
    ffn: str = "dense"
    cross_attn: bool = False
    causal: bool = True

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFNS:
            raise ValueError(f"unknown ffn {self.ffn!r}")


def _pattern(pattern: list[LayerSpec], n: int) -> tuple[LayerSpec, ...]:
    """Repeat ``pattern`` cyclically, truncated to exactly ``n`` layers."""
    out = []
    while len(out) < n:
        out.extend(pattern)
    return tuple(out[:n])


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layers: tuple[LayerSpec, ...] = ()
    # attention
    sliding_window: int = 0
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"            # rope | learned | none
    max_seq_len: int = 1 << 20
    logit_softcap: float = 0.0
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group_size: int = 0
    # recurrent (RG-LRU)
    rnn_width: int = 0
    conv_width: int = 4
    # rwkv
    rwkv_head_dim: int = 64
    # enc-dec / modality frontends
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_media_tokens: int = 0
    # perf variants
    attn_banded: bool = False
    score_dtype: str = "float32"
    # misc
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu | relu2
    gated_mlp: bool = True
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's layout;
        kept so parameters convert 1:1)."""
        return -(-self.vocab_size // 256) * 256

    def num_params(self) -> int:
        """Parameter count of every leaf of ``init_params`` but the final
        norm (left out, as the reference's analytic count leaves it out).
        A MoE FFN counts every expert, the router and the shared expert; a
        cross-attention sublayer its four projections and its norm; an
        encoder block its attention, dense FFN and two norms. Where the
        reference's count differs: an RG-LRU block counts its
        block-diagonal gates ``wa``/``wi`` (2 W²/H), and an RWKV block
        its decay LoRA, token-shift mixes and per-channel vectors, which
        the reference's approximate count leaves out; layernorm counts
        its bias; a cross-attention block counts three norms, where the
        reference counts two a block; learned positions count their
        (max_seq_len, d) table and an encoder its final norm, both of
        which the reference's count leaves out."""
        d = self.d_model
        norm = (2 if self.norm == "layernorm" else 1) * d
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        mult = 3 if self.gated_mlp else 2
        n = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        if self.pos_emb == "learned":
            n += self.max_seq_len * d
        for spec in self.layers:
            if spec.mixer in ("attn", "attn_local"):
                n += attn
            elif spec.mixer == "rglru":
                w = self.rnn_width or d
                # w_gate, w_x, w_out; conv taps + bias; wa, wi; lam
                n += 3 * d * w + (self.conv_width + 1) * w \
                    + 2 * w * w // self.num_heads + w
            elif spec.mixer == "rwkv":
                lora = max(32, d // 64)
                # wr, wk, wv, wg, wo; the decay LoRA wA, wB; mu_r/k/v/w/g,
                # w0, u, ln_out
                n += 5 * d * d + 2 * d * lora + 8 * d
            if spec.cross_attn:
                n += attn + norm  # cross, norm_cross
            if spec.ffn == "dense":
                n += mult * d * self.d_ff
            elif spec.ffn == "moe":
                n += self.num_experts * mult * d * self.moe_d_ff
                n += d * self.num_experts  # router
                if self.shared_expert:
                    n += mult * d * self.moe_d_ff
            elif spec.ffn == "rwkv_cmix":
                n += 2 * d * self.d_ff + d  # wk, wv; mu_k
            n += 2 * norm  # norm1, norm2
        # encoder blocks: attention and a dense FFN; its final norm
        n += self.encoder_layers * (attn + mult * d * self.d_ff + 2 * norm)
        if self.encoder_layers:
            n += norm
        return n

    def num_active_params(self) -> int:
        """Parameters a token passes through: :meth:`num_params` less, in
        every MoE layer, the ``num_experts - top_k`` experts it is not
        routed to (the reference's definition)."""
        if self.num_experts == 0:
            return self.num_params()
        mult = 3 if self.gated_mlp else 2
        moe_layers = sum(1 for s in self.layers if s.ffn == "moe")
        dead = (self.num_experts - self.top_k) * mult * self.d_model \
            * self.moe_d_ff
        return self.num_params() - moe_layers * dead


ARCHS = ["smollm-360m", "recurrentgemma-2b", "rwkv6-7b", "starcoder2-3b",
         "minitron-8b", "gemma3-27b", "phi3.5-moe-42b-a6.6b",
         "llama4-maverick-400b-a17b", "whisper-small",
         "llama-3.2-vision-90b"]

_MODULES = {"smollm-360m": "smollm_360m",
            "recurrentgemma-2b": "recurrentgemma_2b",
            "rwkv6-7b": "rwkv6_7b",
            "starcoder2-3b": "starcoder2_3b",
            "minitron-8b": "minitron_8b",
            "gemma3-27b": "gemma3_27b",
            "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
            "llama4-maverick-400b-a17b": "llama4_maverick_400b",
            "whisper-small": "whisper_small",
            "llama-3.2-vision-90b": "llama32_vision_90b"}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port supports {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.make_reduced() if reduced else mod.make_config()


def reduce_config(cfg: ModelConfig, num_layers: int = 2,
                  d_model: int = 256) -> ModelConfig:
    """Reduced variant for smoke tests: the reference's recipe (head_dim
    32, <= 4 heads, d_ff = 2 d_model, vocab 512), so both packages
    reduce a config to the same shapes."""
    head_dim = 32
    num_heads = max(2, min(4, cfg.num_heads))
    num_kv = 1 if cfg.num_kv_heads < cfg.num_heads else num_heads
    kinds = list(dict.fromkeys(s.mixer for s in cfg.layers))
    layers = [cfg.layers[i % len(cfg.layers)] for i in range(num_layers)]
    # every distinct mixer kind shows up at least once
    for j, k in enumerate(kinds[:num_layers]):
        if all(lay.mixer != k for lay in layers):
            layers[j] = replace(layers[j], mixer=k)
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=2 * d_model,
        vocab_size=512,
        layers=tuple(layers),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=2 * d_model if cfg.moe_d_ff else 0,
        rnn_width=d_model if cfg.rnn_width else 0,
        rwkv_head_dim=32,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 32) if cfg.encoder_seq else 0,
        num_media_tokens=(min(cfg.num_media_tokens, 16)
                          if cfg.num_media_tokens else 0),
        max_seq_len=4096,
    )
