"""Model configuration dataclasses (the port's copy of the JAX package's
``configs/base.py``).

Every language-model architecture is expressed as a ``ModelConfig``; the
model code, the serving engine and the entry points all read the same
type.  The fields, properties and ``reduced()`` are the JAX package's, so a
config built here and one built there describe the same model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    every: int = 1               # MoE MLP every Nth layer (1 = all layers)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"          # 'rwkv6' | 'mamba'
    d_state: int = 16            # mamba state size per channel
    d_conv: int = 4              # mamba conv width
    expand: int = 2              # mamba inner expansion
    head_dim: int = 64           # rwkv6 head size
    lora_rank: int = 64          # rwkv6 data-dependent decay LoRA rank
    chunk: int = 32              # chunked-scan block length (coarse factorization)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_act: str = "swiglu"      # swiglu | gelu
    norm: str = "rms"            # rms | ln
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid interleave: one attention layer every `attn_every` layers
    attn_every: int = 0
    # sliding-window attention (ring-buffer decode cache); 0 = full attention
    sliding_window: int = 0
    # vlm: number of vision-patch embeddings prepended to the text sequence
    n_vis_tokens: int = 0
    vis_dim: int = 0             # raw patch-embedding dim (projector input)
    # audio: number of EnCodec codebooks (parallel token streams)
    n_codebooks: int = 0
    # shard the sequence dim of activations over a 'model' mesh axis
    # (sequence parallelism: the activations' logical axis "seq_model",
    # and the time-mix's sequence-parallel path, rwkv._apply_tmix_seqpar)
    seq_shard: bool = False
    # int8 KV cache (per-token-per-head scales)
    kv_quant: bool = False
    dtype: str = "bfloat16"
    source: str = ""             # provenance citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer i of the stack."""
        if self.attention_free:
            return "ssm"
        if self.attn_every and self.ssm is not None:
            # jamba-style: one attention layer per period, at period midpoint
            return "attn" if i % self.attn_every == self.attn_every // 2 else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every == self.moe.every - 1
                                         if self.moe.every > 1 else True)

    @property
    def period(self) -> int:
        """Layer-pattern period: the blocks are stacked over groups of it."""
        p = 1
        if self.attn_every and self.ssm is not None:
            p = self.attn_every
        if self.moe is not None and self.moe.every > 1:
            p = math.lcm(p, self.moe.every)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return p

    def reduced(self) -> "ModelConfig":
        """Small variant for CPU tests: <=2 periods of layers,
        d_model<=256, <=4 experts, float32."""
        d_model = min(self.d_model, 256)
        period = 1
        if self.attn_every and self.ssm is not None:
            period = self.attn_every
        n_layers = max(2, period)
        if self.moe is not None and self.moe.every > 1:
            n_layers = max(n_layers, math.lcm(period, self.moe.every))
        heads = 0 if self.attention_free else min(self.n_heads, 4)
        kvh = 0 if self.attention_free else max(1, min(self.n_kv_heads,
                                                       heads, 2))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff=min(self.moe.d_ff, 128))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, head_dim=min(self.ssm.head_dim, 32),
                lora_rank=16, chunk=8, d_state=min(self.ssm.d_state, 8))
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers,
            d_model=d_model, n_heads=heads, n_kv_heads=kvh,
            d_ff=min(self.d_ff, 384), vocab=min(self.vocab, 512),
            head_dim=(64 if not self.attention_free else 0),
            moe=moe, ssm=ssm,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_vis_tokens=min(self.n_vis_tokens, 8),
            vis_dim=min(self.vis_dim, 64) if self.vis_dim else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
