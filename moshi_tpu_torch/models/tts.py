"""TTS voice conditioning, voice prefixes and the all-in-one TTS model.

Counterpart of ``moshi_tpu/models/tts.py``:

* ``voice_condition``: condition_sum = output_proj(cfg table row 2, cfg
  2.0) + output_proj(control table row 0, "ok"); condition_cross = 5 * S
  learnt-padding slots with the projected speaker embedding in the first
  S, plus a sinusoidal position embedding (first half cos, second half
  sin);
* ``make_voice_prefix`` for TTS models without cross-attention: the
  Mimi codes of a speaker's audio (from any encode function) as forced
  audio after max_delay + delay_steps empty frames, the semantic codebook
  moved two frames earlier;
* ``TTSModel``: a script in, a waveform out (``generate_wav``), one
  session or several with diverging scripts (``generate_wavs``).

``load_conditioners`` reads the conditioners from the LM checkpoint
("lm.condition_provider.conditioners.*"), as f32 tensors on the device;
``runtime/synth.py`` ``synth_conditioners`` makes a tree of the same form.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from moshi_tpu_torch.models.lm import LMConfig, UNGENERATED, ZERO
from moshi_tpu_torch.nn.layers import linear

FRAME_SIZE = 1920     # samples per 80 ms frame at 24 kHz


def sin_embedding(positions: torch.Tensor, dim: int,
                  max_period: float = 10_000.0) -> torch.Tensor:
    """[T] -> [T, dim] f32: first half cos, second half sin."""
    half = dim // 2
    freqs = torch.exp(-torch.log(torch.tensor(max_period))
                      * torch.arange(half, dtype=torch.float32) / half)
    args = positions.float()[:, None] * freqs.to(positions.device)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def load_conditioners(src, device="cuda") -> dict:
    """The voice conditioners of a cross-attention TTS checkpoint on
    ``device``, f32: ``src`` is the LM checkpoint's path (safetensors or
    GGUF) or an open ``runtime.loader._Source``."""
    from moshi_tpu_torch.device import resolve_device
    from moshi_tpu_torch.runtime.loader import _Source, _f32
    dev = resolve_device(device)
    own = isinstance(src, str)
    if own:
        src = _Source(dev, src)
    base = "lm.condition_provider.conditioners"

    def g(name):
        return _f32(src.get(f"{base}.{name}")).to(dev)

    try:
        return {
            "cfg": {"embed": g("cfg.embed.weight"),
                    "learnt_padding": g("cfg.learnt_padding"),
                    "output_proj": {"weight": g("cfg.output_proj.weight")}},
            "control": {"embed": g("control.embed.weight"),
                        "learnt_padding": g("control.learnt_padding"),
                        "output_proj": {"weight":
                                        g("control.output_proj.weight")}},
            "speaker_wavs": {"learnt_padding": g("speaker_wavs.learnt_padding"),
                             "output_proj": {"weight": g(
                                 "speaker_wavs.output_proj.weight")}},
        }
    finally:
        if own:
            src.close()


def voice_condition(cond: dict, speaker_wavs: torch.Tensor,
                    cfg_index: int = 2, pos_emb_scale: float = 1.0,
                    max_period: float = 10_000.0):
    """speaker_wavs [S, Dw] -> (condition_sum [1, dim], condition_cross
    [1, 5 * S, dim])."""
    cfg_emb = cond["cfg"]["embed"][cfg_index][None, :]
    cfg_c = linear(cond["cfg"]["output_proj"], cfg_emb)
    ctl_emb = cond["control"]["embed"][0][None, :]
    ctl_c = linear(cond["control"]["output_proj"], ctl_emb)
    condition_sum = (cfg_c + ctl_c).reshape(1, -1)
    proj = linear(cond["speaker_wavs"]["output_proj"], speaker_wavs)
    s, dim = proj.shape
    pad = cond["speaker_wavs"]["learnt_padding"].reshape(1, -1)[:, :dim]
    cross = pad.to(proj.dtype).expand(5 * s, dim).clone()
    cross[:s] = proj
    pos = sin_embedding(torch.arange(5 * s, device=proj.device), dim,
                        max_period)
    cross = cross + pos_emb_scale * pos
    return condition_sum, cross[None]


def make_voice_prefix(encode_fn, audio: np.ndarray, lm_cfg: LMConfig,
                      delay_steps: int) -> Tuple[List[int], List[List[int]]]:
    """The voice prefix of a TTS model without cross-attention.
    ``encode_fn``: audio [1, n * 1920] -> codes [1, n, n_q].  Returns
    (text_prefixes, audio_prefixes)."""
    n = (len(audio) // FRAME_SIZE) * FRAME_SIZE
    audio = np.asarray(audio[:n], np.float32)
    nframes = n // FRAME_SIZE
    codes = np.asarray(encode_fn(audio[None]))            # [1, T, n_q]
    codes = codes.reshape(nframes, -1)[:, : lm_cfg.n_q]
    text_prefixes = [ZERO] * nframes
    audio_prefixes: List[List[int]] = [
        [UNGENERATED] * lm_cfg.n_q
        for _ in range(lm_cfg.max_delay + delay_steps)
    ]
    for i in range(nframes):
        frame = [int(c) for c in codes[i]]
        audio_prefixes.append(frame)
        # the semantic codebook moves two frames earlier
        audio_prefixes[-3][0] = frame[0]
        frame[0] = UNGENERATED
    return text_prefixes, audio_prefixes


class TTSModel:
    """A script in, a waveform out: the LM, Mimi, the tokenizer and the
    text StateMachine behind ``TTSPipeline``'s host-FSM step."""

    def __init__(self, lm_cfg, lm_params, mimi, mimi_params, tokenizer,
                 config, *, seed: int = 0, mimi_dtype=torch.bfloat16,
                 device="cuda"):
        from moshi_tpu_torch.models.state_machine import (StateMachine,
                                                          TokenIds)
        from moshi_tpu_torch.runtime.pipeline import TTSPipeline
        self.lm_cfg = lm_cfg
        self.lm_params = lm_params
        self.mimi = mimi
        self.mimi_params = mimi_params
        self.tokenizer = tokenizer
        self.config = config
        self.seed = seed
        self.token_ids = TokenIds(card=lm_cfg.text_card + 1)
        self.machine = StateMachine(
            text_card=lm_cfg.text_card + 1,
            second_stream_ahead=(config.tts_config.second_stream_ahead
                                 if lm_cfg.demux_second_stream else 0),
            max_padding=8, initial_padding=2)
        self.pipe = TTSPipeline(
            mimi, lm_cfg,
            temp=config.lm_gen_config.temp,
            temp_text=config.lm_gen_config.temp_text,
            top_k=config.lm_gen_config.top_k,
            top_k_text=config.lm_gen_config.top_k_text,
            mimi_dtype=mimi_dtype, device=device)

    def _entries(self, script):
        from moshi_tpu_torch.models.state_machine import script_to_entries
        return script_to_entries(self.tokenizer, self.token_ids, 12.5,
                                 script, multi_speaker=False,
                                 padding_between=1)

    def generate_wav(self, script, max_frames: int = 2500,
                     final_padding: int = 4):
        """script: a list of lines.  Returns (wav f32 [T], frames)."""
        mstate = self.machine.new_state(self._entries(script))
        state = self.pipe.init_state(1, seed=self.seed)
        wav = []
        offset = 0
        while offset < max_frames:
            replace = offset < self.lm_cfg.delay_steps
            out, state = self.pipe.step(
                self.mimi_params, self.lm_params, state,
                machine=self.machine, machine_state=mstate, offset=offset,
                depformer_replace=replace)
            if bool(out["valid"][0]) and not replace:
                wav.append(out["audio_out"][0].cpu().numpy())
            offset += 1
            end = mstate.end_step
            if end >= 0 and offset >= end + self.lm_cfg.delay_steps + \
                    final_padding:
                break
        audio = np.concatenate(wav) if wav else np.zeros(FRAME_SIZE,
                                                         np.float32)
        return audio, offset

    def generate_wavs(self, scripts, max_frames: int = 2500,
                      final_padding: int = 4):
        """Several sessions in one batch, each script behind its own
        StateMachine state; runs until every session has passed its own
        end_step + delay + padding.  Returns [(wav f32 [T], end frame)]."""
        b = len(scripts)
        mstates = [self.machine.new_state(self._entries(s)) for s in scripts]
        state = self.pipe.init_state(b, seed=self.seed)
        wavs = [[] for _ in range(b)]
        ends = [0] * b
        offset = 0
        while offset < max_frames:
            replace = offset < self.lm_cfg.delay_steps
            out, state = self.pipe.step(
                self.mimi_params, self.lm_params, state,
                machine=self.machine, machine_state=mstates, offset=offset,
                depformer_replace=replace)
            valid = out["valid"].cpu().numpy()
            audio = out["audio_out"].cpu().numpy()
            offset += 1
            done = 0
            for i, ms in enumerate(mstates):
                end = ms.end_step
                live = end < 0 or offset <= end + self.lm_cfg.delay_steps \
                    + final_padding
                if live:
                    ends[i] = offset
                    if bool(valid[i]) and not replace:
                        wavs[i].append(audio[i])
                else:
                    done += 1
            if done == b:
                break
        return [(np.concatenate(w) if w else np.zeros(FRAME_SIZE,
                                                      np.float32), e)
                for w, e in zip(wavs, ends)]
