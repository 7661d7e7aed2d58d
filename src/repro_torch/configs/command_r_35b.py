"""Command-R 35B — dense GQA decoder, no biases, LayerNorm
[hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    qkv_bias=False,
    mlp_act="swiglu",
    norm="ln",                # Cohere uses (bias-free) LayerNorm
    rope_theta=8_000_000.0,
    tie_embeddings=True,      # command-r ties the LM head
    source="hf:CohereForAI/c4ai-command-r-v01",
)
