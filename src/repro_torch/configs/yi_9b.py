"""Yi-9B — llama-architecture dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
    qkv_bias=False,
    mlp_act="swiglu",
    norm="rms",
    rope_theta=10_000.0,
    source="arXiv:2403.04652",
)
