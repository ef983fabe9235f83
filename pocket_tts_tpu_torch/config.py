"""Typed configuration tree for the PyTorch port.

A copy of pocket_tts_tpu/config.py (the port imports nothing of the JAX
package): the same schema, so every YAML under configs/ loads unchanged,
including `extra="forbid"` strictness and typo-friendly error messages.
"""

from __future__ import annotations

from pathlib import Path

import yaml
from pydantic import BaseModel, ConfigDict

CONFIGS_DIR = Path(__file__).parent / "configs"


class StrictModel(BaseModel):
    model_config = ConfigDict(extra="forbid")


class FlowConfig(StrictModel):
    """Flow-matching head (SimpleMLPAdaLN) size."""

    dim: int
    depth: int


class FlowLMTransformerConfig(StrictModel):
    """Causal backbone transformer of the FlowLM."""

    hidden_scale: int
    max_period: int
    d_model: int
    num_heads: int
    num_layers: int


class LookupTable(StrictModel):
    """Text conditioner: sentencepiece tokenizer + embedding LUT."""

    dim: int
    n_bins: int
    tokenizer: str
    tokenizer_path: str


class FlowLMConfig(StrictModel):
    dtype: str
    flow: FlowConfig
    transformer: FlowLMTransformerConfig
    lookup_table: LookupTable
    weights_path: str | None = None
    insert_bos_before_voice: bool = False


class SEANetConfig(StrictModel):
    dimension: int
    channels: int
    n_filters: int
    n_residual_layers: int
    ratios: list[int]
    kernel_size: int
    residual_kernel_size: int
    last_kernel_size: int
    dilation_base: int
    pad_mode: str
    compress: int


class MimiTransformerConfig(StrictModel):
    d_model: int
    input_dimension: int
    output_dimensions: tuple[int, ...]
    num_heads: int
    num_layers: int
    layer_scale: float
    context: int
    max_period: float = 10000.0
    dim_feedforward: int


class QuantizerConfig(StrictModel):
    dimension: int
    output_dimension: int


class MimiConfig(StrictModel):
    dtype: str
    sample_rate: int
    channels: int
    frame_rate: float
    seanet: SEANetConfig
    transformer: MimiTransformerConfig
    quantizer: QuantizerConfig
    weights_path: str | None = None
    inner_dim: int | None = None
    outer_dim: int | None = None


class Config(StrictModel):
    flow_lm: FlowLMConfig
    mimi: MimiConfig
    weights_path: str | None = None
    weights_path_without_voice_cloning: str | None = None
    pad_with_spaces_for_short_inputs: bool = False
    remove_semicolons: bool = False
    model_recommended_frames_after_eos: int | None = None


def load_config(yaml_path: str | Path) -> Config:
    yaml_path = Path(yaml_path)
    if not yaml_path.exists():
        if yaml_path.is_relative_to(CONFIGS_DIR):
            available = sorted(p.stem for p in CONFIGS_DIR.glob("*.yaml"))
            raise FileNotFoundError(
                f"Config file not found: {yaml_path}. Did you make a typo? "
                f"Available languages: {available}"
            )
        raise FileNotFoundError(f"Config file not found: {yaml_path}. Did you make a typo?")
    with open(yaml_path) as f:
        raw = yaml.safe_load(f)
    return Config(**raw)
