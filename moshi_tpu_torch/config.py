"""Model configuration: parse a model's ``config.json`` into a typed config.

A copy of ``moshi_tpu/config.py`` (the port imports nothing of the JAX
package, even where a module needs no JAX): ``MoshiConfig`` with every key
of the reference's ``moshi_config_t`` and the same defaults, its nested
``FuserConfig``, ``TTSConfig``, ``STTConfig``, ``ModelIdConfig`` and
``LMGenConfig``, and ``parse_config`` / ``load_config``.  Unknown keys are
ignored.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class FuserConfig:
    # reference: include/moshi/moshi.h:81-87
    cross_attention_pos_emb: bool = True
    cross_attention_pos_emb_scale: float = 1.0
    sum: List[str] = field(default_factory=lambda: ["control", "cfg"])
    cross: List[str] = field(default_factory=lambda: ["speaker_wavs"])


@dataclass
class TTSConfig:
    # reference: include/moshi/moshi.h:89-92
    audio_delay: float = 1.28
    second_stream_ahead: int = 2


@dataclass
class STTConfig:
    # reference: include/moshi/moshi.h:94-97 (defaults config.h:151-152)
    audio_delay_seconds: float = 5.0
    audio_silence_prefix_seconds: float = 1.0


@dataclass
class ModelIdConfig:
    sig: str = ""
    epoch: int = 0


@dataclass
class LMGenConfig:
    # reference: include/moshi/moshi.h:104-109
    temp: float = 0.6
    temp_text: float = 0.6
    top_k: int = 250
    top_k_text: int = 50


@dataclass
class MoshiConfig:
    """All keys of the reference moshi_config_t (include/moshi/moshi.h:111-156)."""

    card: int = 2048
    n_q: int = 32
    dep_q: int = 32
    delays: List[int] = field(default_factory=list)
    dim: int = 2048
    text_card: int = 8000
    existing_text_padding_id: int = 3
    num_heads: int = 16
    num_layers: int = 16
    hidden_scale: float = 4.125
    causal: bool = True
    layer_scale: Optional[float] = None
    context: int = 500
    max_period: int = 10_000
    gating: str = "silu"
    norm: str = "rms_norm_f32"
    positional_embedding: str = "rope"
    depformer_dim: int = 1024
    depformer_num_heads: int = 16
    depformer_num_layers: int = 4
    depformer_dim_feedforward: Optional[int] = None  # else from weights
    depformer_hidden_scale: Optional[float] = None
    depformer_multi_linear: bool = True
    depformer_context: int = 0
    depformer_max_period: int = 0
    depformer_gating: str = ""
    depformer_pos_emb: str = "none"
    depformer_weights_per_step: bool = True
    depformer_low_rank_embeddings: int = 128
    demux_second_stream: bool = False
    text_card_out: Optional[int] = None
    fuser: FuserConfig = field(default_factory=FuserConfig)
    cross_attention: bool = False
    extra_heads_num_heads: int = 0
    extra_heads_dim: int = 0
    tts_config: TTSConfig = field(default_factory=TTSConfig)
    stt_config: STTConfig = field(default_factory=STTConfig)
    model_id: ModelIdConfig = field(default_factory=ModelIdConfig)
    depformer_weights_per_step_schedule: List[int] = field(default_factory=list)
    model_type: str = ""
    lm_gen_config: LMGenConfig = field(default_factory=LMGenConfig)
    tokenizer_name: str = ""
    mimi_name: str = ""
    moshi_name: str = ""

    # -- derived helpers -------------------------------------------------
    @property
    def max_delay(self) -> int:
        return max(self.delays) if self.delays else 0

    @property
    def hidden_dim(self) -> int:
        return int(self.dim * self.hidden_scale)

    def effective_delays(self) -> List[int]:
        """delays[] padded/truncated to n_q+1 entries (text stream is index 0)."""
        d = list(self.delays)
        if not d:
            d = [0] * (self.n_q + 1)
        return d


def _fill(dc_obj: Any, data: dict) -> None:
    """Fill a dataclass instance from a dict, ignoring unknown keys."""
    names = {f.name: f for f in dataclasses.fields(dc_obj)}
    for key, value in data.items():
        if key not in names:
            continue
        current = getattr(dc_obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _fill(current, value)
        elif value is not None:
            setattr(dc_obj, key, value)


def parse_config(data: dict) -> MoshiConfig:
    cfg = MoshiConfig()
    _fill(cfg, data)
    # the reference treats a missing schedule as "identity by step"
    if cfg.depformer_weights_per_step and not cfg.depformer_weights_per_step_schedule:
        cfg.depformer_weights_per_step_schedule = list(range(cfg.dep_q))
    return cfg


def load_config(path: str) -> MoshiConfig:
    with open(path, "r") as fh:
        return parse_config(json.load(fh))
