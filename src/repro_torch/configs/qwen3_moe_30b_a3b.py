"""Qwen3-30B-A3B — MoE decoder: 128 experts, top-8, every layer
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                 # per-expert FFN hidden dim
    vocab=151936,
    head_dim=128,             # decoupled from d_model (Qwen3 style)
    qkv_bias=False,
    mlp_act="swiglu",
    norm="rms",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, every=1),
    source="hf:Qwen/Qwen3-30B-A3B",
)
