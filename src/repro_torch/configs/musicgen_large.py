"""MusicGen-large — decoder-only transformer over EnCodec audio tokens
[arXiv:2306.05284].

The backbone only, as in the JAX package: the EnCodec tokenizer/codec is a
stub; the model consumes 4 parallel codebook token streams (the delay
pattern collapsed to a sum of the codebooks' embeddings) and predicts all 4
codebooks a step through 4 heads.  The original uses learned sinusoidal
positions; the JAX package uses RoPE, and so does the port — the decoder
structure (MHA kv=32, GELU FFN, LN) is kept.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,            # full multi-head attention
    d_ff=8192,
    vocab=2048,               # EnCodec codebook size
    head_dim=64,
    qkv_bias=False,
    mlp_act="gelu",
    norm="ln",
    rope_theta=10_000.0,
    n_codebooks=4,
    source="arXiv:2306.05284",
)
