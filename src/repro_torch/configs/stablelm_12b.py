"""StableLM-2-12B — dense GQA decoder [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    head_dim=160,
    qkv_bias=False,
    mlp_act="swiglu",
    norm="ln",                # StableLM-2 uses LayerNorm
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
)
