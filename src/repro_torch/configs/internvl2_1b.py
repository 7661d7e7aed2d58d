"""InternVL2-1B — InternViT-300M vision encoder + Qwen2-0.5B language decoder
[arXiv:2404.16821].

The backbone only, as in the JAX package: the ViT is a stub —
``models/registry.input_specs`` provides precomputed patch embeddings
(n_vis_tokens x vis_dim) which a learned 2-layer projector maps into the
decoder's embedding space and prepends to the text token sequence.  The
language decoder below is the Qwen2-0.5B configuration with InternVL2's
vocab.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    mlp_act="swiglu",
    norm="rms",
    rope_theta=1_000_000.0,
    n_vis_tokens=256,         # 256 patch tokens per image tile
    vis_dim=1024,             # InternViT-300M hidden size
    source="arXiv:2404.16821",
)
