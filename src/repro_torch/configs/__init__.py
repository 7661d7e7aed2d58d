"""Architecture registry of the port: the paper's LSTM and the language
models whose paths are ported (``ARCHS``; ``get_arch`` takes a
``-reduced`` suffix for the small CPU variant): RWKV6-3B, the four dense
GQA decoders and Jamba.  Jamba's MoE layers are not ported yet: its entry
raises where it is built, and its attention-free stack is
``dataclasses.replace`` of it."""
from repro_torch.configs import (command_r_35b, jamba_1_5_large_398b,
                                 mobirnn_lstm, qwen2_0_5b, rwkv6_3b,
                                 stablelm_12b, yi_9b)
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

MOBIRNN_LSTM = mobirnn_lstm.CONFIG

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    rwkv6_3b.CONFIG, qwen2_0_5b.CONFIG, yi_9b.CONFIG, stablelm_12b.CONFIG,
    command_r_35b.CONFIG, jamba_1_5_large_398b.CONFIG]}


def get_arch(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return ARCHS[name[: -len("-reduced")]].reduced()
    return ARCHS[name]


__all__ = ["ARCHS", "MOBIRNN_LSTM", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_arch", "mobirnn_lstm"]
