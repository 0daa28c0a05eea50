"""The streaming frames: full-duplex speech-to-speech, speech-to-text and
text-to-speech.

Counterpart of ``moshi_tpu/runtime/pipeline.py`` ``STSPipeline``,
``STTPipeline`` (the frame function, ``init_state`` and ``step``) and
``TTSPipeline``.  Per 80 ms frame, STS runs

    mic audio [B, 1920] -> Mimi encode -> the other stream's tokens
    -> LM frame (temporal stack, text sampling, depformer, delay cache)
    -> Mimi decode of the generated audio tokens -> speaker audio [B, 1920]

and STT runs Mimi encode -> the LM frame (dep_q = 0: no depformer) -> the
text token and the VAD probability.  TTS runs the LM's text phase (with
the voice conditioning: ``condition_sum`` and the cross K/V), the text
StateMachine on the sampled token, the audio phase (depformer, delay
cache) and Mimi decode: ``step`` with the host FSM (one fetch of the
sampled tokens per frame), ``step_device`` with the device FSM
(``models/device_machine.py``; no host round trip), and ``scan_device``,
frames of ``step_device`` whose outputs stay on the device.

The JAX package jits the whole frame into one program; here the frame
runs eagerly, its kernels launched by the LM's wrappers.  Sampling draws
from a ``torch.Generator`` held in the state (the JAX state held a
threefry key).  Not ported yet: the offline ``scan_frames`` (STS and
STT).
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.models.lm import (UNGENERATED, LMConfig, init_gen_state,
                                      lm_audio_step, lm_gen_step,
                                      lm_text_step)
from moshi_tpu_torch.models.mimi import MimiModel


class STSPipeline:
    """Full-duplex speech-to-speech, one frame per ``step``."""

    def __init__(self, mimi: MimiModel, lm_cfg: LMConfig, *,
                 temp: float = 0.8, temp_text: float = 0.7,
                 top_k: int = 250, top_k_text: int = 25,
                 mimi_dtype=torch.bfloat16, device="cuda"):
        self.mimi = mimi
        self.lm_cfg = lm_cfg
        self.temp, self.temp_text = temp, temp_text
        self.top_k, self.top_k_text = top_k, top_k_text
        self.mimi_dtype = mimi_dtype
        self.device = resolve_device(device)
        self.frame_samples = mimi.cfg.frame_samples

    def init_state(self, batch: int, seed: int = 0, lm_params=None):
        """Fresh Mimi and LM states on the pipeline's device, and the
        sampling generator seeded with ``seed``.  Given ``lm_params``, the
        LM's rings take the temporal megakernel's layout where it applies
        (``init_gen_state``); the pools pass none, so B > 1 never does."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {
            "enc": self.mimi.init_encode_state(batch, self.mimi_dtype, dev),
            "lm": init_gen_state(self.lm_cfg, batch, device=dev,
                                 params=lm_params),
            "dec": self.mimi.init_decode_state(batch, self.mimi_dtype, dev),
            "generator": gen,
        }

    def step(self, mimi_params, lm_params, state, audio_in,
             condition_sum=None):
        """audio_in [B, frame_samples] f32 -> (outputs {audio_out [B,
        frame_samples] f32, text [B], valid [B], audio_tokens [B, dep_q]},
        new_state).  The states' rings are updated in place."""
        lm_cfg = self.lm_cfg
        n_other = lm_cfg.n_q - lm_cfg.runtime_dep_q
        dep_q = lm_cfg.runtime_dep_q
        mimi_n_q = self.mimi.cfg.n_q
        audio_in = torch.as_tensor(audio_in, device=self.device)
        codes, enc_state = self.mimi.encode_step(
            mimi_params, state["enc"], audio_in.to(self.mimi_dtype))
        other = codes[:, 0, :n_other] if n_other else None
        out, lm_state = lm_gen_step(
            lm_cfg, lm_params, state["lm"], other_audio=other,
            condition_sum=condition_sum, temp=self.temp,
            temp_text=self.temp_text, top_k=self.top_k,
            top_k_text=self.top_k_text, generator=state["generator"])
        # decode our dep_q streams: -1/-2 -> 0, the other books padded with 0
        audio_codes = torch.where(out["audio"] < 0,
                                  torch.zeros_like(out["audio"]),
                                  out["audio"])
        if dep_q < mimi_n_q:
            pad = torch.zeros((audio_codes.shape[0], mimi_n_q - dep_q),
                              dtype=audio_codes.dtype,
                              device=audio_codes.device)
            audio_codes = torch.cat([audio_codes, pad], dim=-1)
        wav, dec_state = self.mimi.decode_step(
            mimi_params, state["dec"], audio_codes[:, None, :mimi_n_q])
        new_state = {"enc": enc_state, "lm": lm_state, "dec": dec_state,
                     "generator": state["generator"]}
        return {"audio_out": wav.float(), "text": out["text"],
                "valid": out["valid"], "audio_tokens": out["audio"]}, \
            new_state


class STTPipeline:
    """Speech-to-text: Mimi encode and the LM frame (dep_q = 0), with the
    VAD head's probability, one frame per ``step``."""

    def __init__(self, mimi: MimiModel, lm_cfg: LMConfig, *,
                 temp_text: float = 0.0, top_k_text: int = 25,
                 mimi_dtype=torch.bfloat16, device="cuda"):
        self.mimi = mimi
        self.lm_cfg = lm_cfg
        self.temp_text, self.top_k_text = temp_text, top_k_text
        self.mimi_dtype = mimi_dtype
        self.device = resolve_device(device)
        self.frame_samples = mimi.cfg.frame_samples

    def init_state(self, batch: int, seed: int = 0, lm_params=None):
        """Fresh Mimi encoder and LM states on the pipeline's device, and
        the sampling generator seeded with ``seed``.  Given ``lm_params``,
        the LM's rings take the temporal megakernel's layout where it
        applies (``init_gen_state``)."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {
            "enc": self.mimi.init_encode_state(batch, self.mimi_dtype, dev),
            "lm": init_gen_state(self.lm_cfg, batch, device=dev,
                                 params=lm_params),
            "generator": gen,
        }

    def step(self, mimi_params, lm_params, state, audio_in):
        """audio_in [B, frame_samples] f32 -> (outputs {text [B] (the
        sampled text token), vad [B] f32 (zeros without a VAD head)},
        new_state).  The states' rings are updated in place."""
        lm_cfg = self.lm_cfg
        n_other = lm_cfg.n_q - lm_cfg.runtime_dep_q
        audio_in = torch.as_tensor(audio_in, device=self.device)
        codes, enc_state = self.mimi.encode_step(
            mimi_params, state["enc"], audio_in.to(self.mimi_dtype))
        out, lm_state = lm_gen_step(
            lm_cfg, lm_params, state["lm"], other_audio=codes[:, 0, :n_other],
            temp_text=self.temp_text, top_k_text=self.top_k_text,
            generator=state["generator"])
        vad = out.get("vad")
        if vad is None:
            vad = torch.zeros(audio_in.shape[0], dtype=torch.float32,
                              device=self.device)
        return {"text": out["sampled_text"], "vad": vad}, \
            {"enc": enc_state, "lm": lm_state,
             "generator": state["generator"]}


class TTSPipeline:
    """Text-to-speech frames: the LM's text phase, the text StateMachine,
    the audio phase and Mimi decode."""

    def __init__(self, mimi: MimiModel, lm_cfg: LMConfig, *,
                 temp: float = 0.6, temp_text: float = 0.6,
                 top_k: int = 250, top_k_text: int = 25,
                 mimi_dtype=torch.bfloat16, device="cuda"):
        self.mimi = mimi
        self.lm_cfg = lm_cfg
        self.temp, self.temp_text = temp, temp_text
        self.top_k, self.top_k_text = top_k, top_k_text
        self.mimi_dtype = mimi_dtype
        self.device = resolve_device(device)
        self.frame_samples = mimi.cfg.frame_samples
        self._dep_q = lm_cfg.runtime_dep_q
        self._dm = None

    def init_state(self, batch: int, seed: int = 0, lm_params=None):
        """Fresh LM and Mimi decoder states on the pipeline's device, and
        the sampling generator seeded with ``seed``.  Given ``lm_params``,
        the LM's rings take the temporal megakernel's layout where it
        applies (``init_gen_state``)."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {
            "lm": init_gen_state(self.lm_cfg, batch, device=dev,
                                 params=lm_params),
            "dec": self.mimi.init_decode_state(batch, self.mimi_dtype, dev),
            "generator": gen,
        }

    def _text_phase(self, lm_params, state, condition_sum, cross_kv):
        return lm_text_step(self.lm_cfg, lm_params, state["lm"],
                            condition_sum=condition_sum, cross_kv=cross_kv,
                            temp_text=self.temp_text,
                            top_k_text=self.top_k_text,
                            generator=state["generator"])

    def _audio_phase(self, mimi_params, lm_params, state, lm_state,
                     text_token, h, forced_audio, replace):
        out, lm_state = lm_audio_step(
            self.lm_cfg, lm_params, lm_state, text_token, h,
            forced_audio=forced_audio, depformer_replace=replace,
            temp=self.temp, top_k=self.top_k, generator=state["generator"])
        codes = torch.where(out["audio"] < 0, torch.zeros_like(out["audio"]),
                            out["audio"])
        mimi_n_q = self.mimi.cfg.n_q
        if self._dep_q < mimi_n_q:
            pad = torch.zeros((codes.shape[0], mimi_n_q - self._dep_q),
                              dtype=codes.dtype, device=codes.device)
            codes = torch.cat([codes, pad], dim=-1)
        wav, dec_state = self.mimi.decode_step(
            mimi_params, state["dec"], codes[:, None, :mimi_n_q])
        return ({"audio_out": wav.float(), "valid": out["valid"],
                 "text": out["text"], "sampled_text": out["sampled_text"],
                 "audio_tokens": out["audio"]},
                {"lm": lm_state, "dec": dec_state,
                 "generator": state["generator"]})

    def _forced_audio(self, b, forced_audio):
        if forced_audio is None:
            return torch.full((b, self._dep_q), UNGENERATED,
                              dtype=torch.int64, device=self.device)
        return torch.as_tensor(forced_audio, device=self.device)

    def step(self, mimi_params, lm_params, state, machine=None,
             machine_state=None, offset=0, forced_text=None,
             forced_audio=None, condition_sum=None, cross_kv=None,
             depformer_replace: bool = False):
        """One TTS frame with the host FSM: the sampled text tokens come to
        the host in one copy and each goes through its slot's machine
        (``machine_state`` one MachineState, or one per slot; ``offset``
        an int or one per slot).  ``forced_text`` (an int) replaces the
        text token; ``forced_audio`` [B, dep_q] with UNGENERATED = keep.
        Returns (outputs {audio_out, valid, text, sampled_text,
        audio_tokens}, new_state)."""
        tok, h, lm_state = self._text_phase(lm_params, state,
                                            condition_sum, cross_kv)
        b = tok.shape[0]
        if forced_text is not None:
            tok = torch.full((b,), int(forced_text), dtype=torch.int64,
                             device=self.device)
        elif machine is not None:
            toks = tok.cpu().tolist()
            mstates = (machine_state if isinstance(machine_state,
                                                   (list, tuple))
                       else [machine_state])
            if len(mstates) != b:
                raise ValueError(f"{len(mstates)} machine states for {b} "
                                 f"slots")
            offs = (list(offset) if isinstance(offset, (list, tuple))
                    else [offset] * b)
            tok = torch.tensor([machine.process(int(offs[i]), ms, toks[i])
                                for i, ms in enumerate(mstates)],
                               dtype=torch.int64, device=self.device)
        return self._audio_phase(mimi_params, lm_params, state, lm_state,
                                 tok, h, self._forced_audio(b, forced_audio),
                                 depformer_replace)

    def enable_device_fsm(self, machine):
        """Use ``machine``'s parameters for ``step_device``; returns its
        DeviceMachineConfig."""
        from moshi_tpu_torch.models.device_machine import \
            machine_device_config
        self._dm = machine_device_config(machine)
        return self._dm

    def step_device(self, mimi_params, lm_params, state, mstate, script,
                    forced_text=None, forced_audio=None, condition_sum=None,
                    cross_kv=None, depformer_replace: bool = False):
        """One TTS frame with the FSM on the device (``enable_device_fsm``
        first).  ``forced_text`` [B] with -1 = let the machine drive;
        ``forced_audio`` [B, dep_q] with UNGENERATED = keep.  Returns
        (outputs, new_state, new_mstate); outputs["end_step"] is the
        device-side end marker (-1 while the script runs)."""
        from moshi_tpu_torch.models.device_machine import device_machine_step
        if self._dm is None:
            raise RuntimeError("call enable_device_fsm first")
        b = state["lm"]["offset"].shape[0]
        if forced_text is None:
            forced_text = torch.full((b,), -1, dtype=torch.int64,
                                     device=self.device)
        forced_text = torch.as_tensor(forced_text, device=self.device).long()
        offset = state["lm"]["offset"]
        tok, h, lm_state = self._text_phase(lm_params, state,
                                            condition_sum, cross_kv)
        mtok, mstate = device_machine_step(self._dm, script, mstate, offset,
                                           tok, forced_text < 0)
        tok = torch.where(forced_text >= 0, forced_text, mtok.long())
        out, new_state = self._audio_phase(
            mimi_params, lm_params, state, lm_state, tok, h,
            self._forced_audio(b, forced_audio), depformer_replace)
        out["end_step"] = mstate["end_step"]
        out["machine_text"] = tok
        return out, new_state, mstate

    def scan_device(self, mimi_params, lm_params, state, mstate, script,
                    n_frames: int, condition_sum=None, cross_kv=None):
        """``n_frames`` frames of ``step_device`` whose outputs stay on the
        device: (audio [n, B, samples], valid [n, B], end_step [n, B],
        state, mstate), for the caller to fetch in one copy."""
        audio, valid, end = [], [], []
        for _ in range(n_frames):
            out, state, mstate = self.step_device(
                mimi_params, lm_params, state, mstate, script,
                condition_sum=condition_sum, cross_kv=cross_kv)
            audio.append(out["audio_out"])
            valid.append(out["valid"])
            end.append(out["end_step"])
        return (torch.stack(audio), torch.stack(valid), torch.stack(end),
                state, mstate)
