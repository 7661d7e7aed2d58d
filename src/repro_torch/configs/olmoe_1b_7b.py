"""OLMoE-1B-7B — MoE decoder: 64 experts, top-8, every layer
[arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,            # MHA
    d_ff=1024,                # per-expert FFN hidden dim
    vocab=50304,
    head_dim=128,
    qkv_bias=False,
    mlp_act="swiglu",
    norm="rms",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024, every=1),
    source="arXiv:2409.02060",
)
