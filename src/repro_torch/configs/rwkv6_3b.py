"""RWKV6 (Finch) 3B — attention-free RNN with data-dependent decay
[arXiv:2404.05892].

The architecture where the paper's (MobiRNN's) technique applies in full:
the wkv state scan is the LSTM cell's analogue, the chunked scan is the
coarse work-unit factorization, and the per-layer (state, shift) buffers
live in the preallocated state pool.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,                # attention-free
    n_kv_heads=0,
    d_ff=8960,                # channel-mix hidden dim (3.5x)
    vocab=65536,
    norm="ln",
    ssm=SSMConfig(kind="rwkv6", head_dim=64, lora_rank=64, chunk=32),
    seq_shard=True,           # read by the partitioning rules and the
                              # sequence-parallel time-mix
                              # (models/rwkv._apply_tmix_seqpar)
    source="arXiv:2404.05892",
)
