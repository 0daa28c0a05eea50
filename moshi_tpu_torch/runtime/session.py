"""Streaming sessions: the send/receive API over the frame steps.

Counterpart of ``moshi_tpu/runtime/session.py``:

* ``LMGenerator``: the LM's frames driven from the host, one ``step`` (or
  ``receive`` / ``receive2``) a frame: the other stream's tokens given by
  ``send2``, the TTS text StateMachine (one FSM state per session slot,
  fed by ``send``) between the text and the audio phase, text and audio
  prefix queues, the skip after an audio prefix, and the
  depformer-replace lead-in while the offset is below ``delay_steps``;
  ``is_active`` holds a TTS session open for ``FINAL_PADDING`` frames
  after its script's end and the delays;
* ``MimiStreamer``: Mimi's streaming encode and decode contexts.

The frames run eagerly through ``models/lm.py`` ``lm_gen_step`` (without
a machine) or ``lm_text_step`` and ``lm_audio_step`` (with one), which
launch the port's kernels; sampling draws from a ``torch.Generator``
seeded with ``seed`` (the JAX package's state held a threefry key).  A
wrapper carries B sessions in one batch.  Results come back to the host
as numpy arrays, as in the JAX package.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.models.lm import (UNGENERATED, LMConfig, init_gen_state,
                                      lm_audio_step, lm_gen_step,
                                      lm_text_step)
from moshi_tpu_torch.models.mimi import MimiModel
from moshi_tpu_torch.models.state_machine import MachineState, StateMachine

FINAL_PADDING = 4  # frames a TTS session stays active after the delays


class LMGenerator:
    """B sessions of the LM frame behind the reference's generator calls
    (start/send/receive/send2/receive2/is_active/is_empty/
    machine_reset).  ``condition_sum`` and ``cross_kv`` condition every
    frame (the voice of a cross-attention TTS model)."""

    def __init__(self, cfg: LMConfig, params, *, batch: int = 1,
                 temp: float = 0.8, temp_text: float = 0.7,
                 top_k: int = 250, top_k_text: int = 25,
                 machine: Optional[StateMachine] = None,
                 condition_sum=None, cross_kv=None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.temp, self.temp_text = temp, temp_text
        self.top_k, self.top_k_text = top_k, top_k_text
        self.machine = machine
        # one FSM state per session slot: diverging scripts in one batch
        self.machine_states: List[MachineState] = (
            [machine.new_state() for _ in range(batch)] if machine else [])
        self.condition_sum = condition_sum
        self.cross_kv = cross_kv
        self.device = resolve_device(device)
        self.text_prefixes: Deque[int] = deque()
        self.audio_prefixes: Deque[List[int]] = deque()
        self.skip_prefix = 2  # frames without audio after an audio prefix
        n_other = cfg.n_q - cfg.runtime_dep_q
        self._none_other = (torch.zeros((batch, n_other), dtype=torch.int64,
                                        device=self.device)
                            if n_other else None)
        self._pending_other: Optional[np.ndarray] = None
        self.reset(seed)

    @property
    def machine_state(self) -> Optional[MachineState]:
        """Slot 0's FSM state (the reference's one-session API)."""
        return self.machine_states[0] if self.machine_states else None

    def send(self, entry, slot: int = 0):
        """Queue a TTS word Entry for session ``slot``."""
        if not self.machine_states:
            raise RuntimeError("no state machine: not a TTS generator")
        self.machine_states[slot].entries.append(entry)

    def send2(self, audio_tokens):
        """The other stream's audio tokens for the next frame."""
        self._pending_other = np.asarray(audio_tokens, np.int64).reshape(
            self.batch, -1)

    def _forced_audio(self):
        """[B, dep_q] int64: the next audio prefix (its books first,
        UNGENERATED after), starting the skip; all UNGENERATED without
        one."""
        arr = np.full((self.batch, self.cfg.runtime_dep_q), UNGENERATED,
                      np.int64)
        if self.audio_prefixes:
            self.skip = self.skip_prefix
            codes = self.audio_prefixes.popleft()
            arr[:, : len(codes)] = [int(c) for c in codes]
        return torch.from_numpy(arr).to(self.device)

    def step(self, depformer_replace: Optional[bool] = None):
        """One frame.  Returns the host's results {sampled_text [B], text
        [B], audio [B, dep_q], has_audio [B] and, with a VAD head, vad
        [B]}."""
        cfg = self.cfg
        if depformer_replace is None:
            depformer_replace = self._offset < cfg.delay_steps
        other = (torch.from_numpy(self._pending_other).to(self.device)
                 if self._pending_other is not None else self._none_other)
        self._pending_other = None
        forced_audio = self._forced_audio()
        if self.machine is not None:
            tok, h, state = lm_text_step(
                cfg, self.params, self.state, other_audio=other,
                condition_sum=self.condition_sum, cross_kv=self.cross_kv,
                temp_text=self.temp_text, top_k_text=self.top_k_text,
                generator=self.generator)
            if self.text_prefixes:
                text = [int(self.text_prefixes.popleft())] * self.batch
            else:
                # one fetch, then each slot's token through its own FSM
                toks = tok.cpu().tolist()
                text = [self.machine.process(self._offset, ms, toks[i])
                        for i, ms in enumerate(self.machine_states)]
            text_arr = torch.tensor(text, dtype=torch.int64,
                                    device=self.device)
            out, self.state = lm_audio_step(
                cfg, self.params, state, text_arr, h,
                forced_audio=forced_audio,
                depformer_replace=depformer_replace, temp=self.temp,
                top_k=self.top_k, generator=self.generator)
        else:
            out, self.state = lm_gen_step(
                cfg, self.params, self.state, other_audio=other,
                forced_audio=forced_audio,
                condition_sum=self.condition_sum, cross_kv=self.cross_kv,
                depformer_replace=depformer_replace, temp=self.temp,
                temp_text=self.temp_text, top_k=self.top_k,
                top_k_text=self.top_k_text, generator=self.generator)
        self._offset += 1
        result = {"sampled_text": out["sampled_text"].cpu().numpy(),
                  "text": out["text"].cpu().numpy(),
                  "audio": out["audio"].cpu().numpy(),
                  "has_audio": out["valid"].cpu().numpy().copy()}
        if "vad" in out:
            result["vad"] = out["vad"].cpu().numpy()
        if self.skip > 0:
            self.skip -= 1
            result["has_audio"][:] = False
        return result

    def receive(self):
        """The TTS / STS output side: one frame."""
        return self.step()

    def receive2(self):
        """The STT side: one frame, text and VAD (no depformer
        lead-in)."""
        return self.step(depformer_replace=False)

    def is_active(self, slot: Optional[int] = None) -> bool:
        """Whether a session still has frames to give: always without a
        machine; with one, until ``FINAL_PADDING`` frames past its
        script's end and the delays.  ``slot=None``: any slot."""
        if not self.machine_states:
            return True
        states = (self.machine_states if slot is None
                  else [self.machine_states[slot]])
        for ms in states:
            end = ms.end_step
            if end == -1 or self._offset < end + self.cfg.delay_steps \
                    + FINAL_PADDING:
                return True
        return False

    def is_empty(self, slot: int = 0) -> bool:
        return not self.machine_states or \
            self.machine_states[slot].is_empty()

    def machine_reset(self):
        if self.machine:
            for ms in self.machine_states:
                self.machine.reset_state(ms)

    def reset(self, seed: int = 0):
        """A fresh LM state and a generator seeded with ``seed``; the
        queues, the skip and the FSM states emptied."""
        self.state = init_gen_state(self.cfg, self.batch,
                                    device=self.device, params=self.params)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._offset = 0
        self.skip = 0
        self.text_prefixes.clear()
        self.audio_prefixes.clear()
        self.machine_reset()


class MimiStreamer:
    """Mimi's streaming encode and decode contexts for B streams, in
    ``dtype`` (weights, carried states and the audio going in)."""

    def __init__(self, model: MimiModel, params, batch: int = 1,
                 dtype=torch.float32, device="cuda"):
        self.model = model
        self.params = params
        self.batch = batch
        self.dtype = dtype
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self.enc_state = self.model.init_encode_state(self.batch, self.dtype,
                                                      self.device)
        self.dec_state = self.model.init_decode_state(self.batch, self.dtype,
                                                      self.device)

    def encode(self, frame) -> np.ndarray:
        """frame [B, n*1920] f32 -> codes [B, n, n_q] int32."""
        audio = torch.as_tensor(np.asarray(frame, np.float32),
                                device=self.device)
        codes, self.enc_state = self.model.encode_step(
            self.params, self.enc_state,
            audio.to(self.dtype).reshape(self.batch, -1))
        return codes.to(torch.int32).cpu().numpy()

    def decode(self, codes) -> np.ndarray:
        """codes [B, n, n_q] (or one frame [B, n_q]; fewer books padded
        with 0, -1 read as 0) -> audio [B, n*1920] f32."""
        codes = np.asarray(codes, np.int64)
        if codes.ndim == 2:
            codes = codes[:, None, :]
        n_q = self.model.cfg.n_q
        if codes.shape[-1] < n_q:
            pad = np.zeros(codes.shape[:-1] + (n_q - codes.shape[-1],),
                           np.int64)
            codes = np.concatenate([codes, pad], axis=-1)
        codes = np.where(codes < 0, 0, codes)
        audio, self.dec_state = self.model.decode_step(
            self.params, self.dec_state,
            torch.from_numpy(np.ascontiguousarray(codes[..., :n_q]))
            .to(self.device))
        return audio.float().cpu().numpy()
