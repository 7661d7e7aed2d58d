"""Architecture registry of the port: the paper's LSTM and the language
models whose paths are ported (``ARCHS``; ``get_arch`` takes a
``-reduced`` suffix for the small CPU variant): RWKV6-3B, the four dense
GQA decoders, the two MoE decoders OLMoE-1B-7B and Qwen3-30B-A3B, the
Jamba hybrid (its one-card cuts are ``dataclasses.replace`` of it, in
``configs/jamba_1_5_large_398b.py``), and the two modality fronts,
InternVL2-1B (vision tokens) and MusicGen-large (audio codebooks); and the
input shapes of the JAX package (``INPUT_SHAPES``, ``get_shape``)."""
from repro_torch.configs import (command_r_35b, internvl2_1b,
                                 jamba_1_5_large_398b, mobirnn_lstm,
                                 musicgen_large, olmoe_1b_7b, qwen2_0_5b,
                                 qwen3_moe_30b_a3b, rwkv6_3b, stablelm_12b,
                                 yi_9b)
from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, MoEConfig,
                                      SSMConfig, ShapeConfig)

MOBIRNN_LSTM = mobirnn_lstm.CONFIG

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    rwkv6_3b.CONFIG, qwen2_0_5b.CONFIG, yi_9b.CONFIG, stablelm_12b.CONFIG,
    command_r_35b.CONFIG, olmoe_1b_7b.CONFIG, qwen3_moe_30b_a3b.CONFIG,
    jamba_1_5_large_398b.CONFIG, internvl2_1b.CONFIG, musicgen_large.CONFIG]}


def get_arch(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return ARCHS[name[: -len("-reduced")]].reduced()
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


__all__ = ["ARCHS", "INPUT_SHAPES", "MOBIRNN_LSTM", "ModelConfig",
           "MoEConfig", "SSMConfig", "ShapeConfig", "get_arch", "get_shape",
           "mobirnn_lstm"]
