"""Jamba-1.5-Large (398B) — hybrid Mamba+attention (1:7 interleave) with MoE
[arXiv:2403.19887].

Layer pattern (period 8): one attention layer per 8 (at period midpoint),
seven Mamba layers; MoE MLP on every second layer (16 experts, top-2).
The port runs every layer kind of the period: Mamba, attention, the dense
MLP and MoE.  Two cuts of it at Jamba's width, which the JAX package's
config takes the same way:
``dataclasses.replace(CONFIG, **ATTENTION_FREE, n_layers=L)`` is the
attention-free stack (Mamba + SwiGLU MLP in every layer), and
``ONE_PERIOD_8_EXPERTS`` is the whole hybrid, one period of 8 layers with
8 experts where the configuration has 16 (25.9 B parameters, 51.8 GB in
bf16: one period at 16 experts is 45.2 B, over one 80 GB card).  Every
matrix keeps its published shape; top-2 routing and the period's layer
kinds stay.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    qkv_bias=False,
    mlp_act="swiglu",
    norm="rms",
    rope_theta=10_000.0,      # jamba attn layers are NoPE; rope kept, noted
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576, every=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2, chunk=64),
    attn_every=8,
    source="arXiv:2403.19887",
)

#: the fields that take attention and MoE out of the stack: every layer is
#: then Mamba + SwiGLU MLP (``ModelConfig.attention_free``, period 1)
ATTENTION_FREE = dict(n_heads=0, n_kv_heads=0, attn_every=0, moe=None)

#: the whole hybrid cut to one card: one period (attention at slot 4, Mamba
#: at the other seven, MoE on the odd slots) with 8 of the 16 experts
ONE_PERIOD_8_EXPERTS = dataclasses.replace(
    CONFIG, n_layers=8, moe=dataclasses.replace(CONFIG.moe, n_experts=8))
