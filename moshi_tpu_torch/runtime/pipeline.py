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
threefry key).

The offline scans (``STSPipeline.scan_frames``, ``STTPipeline
.scan_frames``) take every input frame at once and run in phases: Mimi
encode of all frames, one ``encode_step`` per chunk of
``transformer_context // frames_per_step`` frames (125 for the real
Mimi; the last chunk shorter) on a Mimi whose rings hold context + one
chunk of positions (``_offline_mimi``), so that the T = 2 x chunk
positions of a call never evict a key still in the window; then the LM
over the codes, ``lm_gen_step`` frame by frame in order, drawing from the
state's generator (the JAX package's chunked ``lax.scan``s, whose
chunking changes no output); then, for STS, Mimi decode of the generated
tokens in the same chunks.  A streaming state enters mid-stream: its
Mimi rings are re-slotted into the offline capacity (``_grow_rings``).
A state a scan returns goes on with ``scan_frames``, not ``step`` (its
Mimi rings hold the offline capacity).  The outputs stay on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.models.lm import (UNGENERATED, LMConfig, init_gen_state,
                                      lm_audio_step, lm_gen_step,
                                      lm_text_step)
from moshi_tpu_torch.models.mimi import MimiModel
from moshi_tpu_torch.nn.ring import ring_index_copy_


def _offline_mimi(mimi: MimiModel, chunk_frames: int) -> MimiModel:
    """A MimiModel on the same parameters whose transformer rings hold
    context + ``chunk_frames`` steps of positions, so that a call's T > 1
    positions never evict a key still in the window (a ring of context
    slots drops the oldest window keys when several positions go in at
    once)."""
    cap = (mimi.cfg.transformer_context
           + chunk_frames * mimi.cfg.frames_per_step)
    return MimiModel(dataclasses.replace(mimi.cfg,
                                         transformer_capacity=cap))


def _grow_rings(tr_state, offset, newcap: int):
    """Re-slot a transformer ring state {k, v: [L, B, cap, H, hd]} into
    ``newcap`` slots: position p moves from slot p % cap to slot
    p % newcap, and never-written positions stay zero.  Those go to a
    sacrificial slot ``newcap``, dropped after the copy: an indexed copy
    with repeated indices keeps any one of them (on CUDA not even the
    same one each time), so a repeat on a real slot could wipe it.
    Returns new rings (contiguous), or ``tr_state`` itself when its
    capacity is already ``newcap``."""
    k = tr_state["k"]
    l, b, oldcap, h, hd = k.shape
    if oldcap == newcap:
        return tr_state
    last = offset.long() - 1                                   # [B]
    p = last[:, None] - torch.arange(oldcap, device=k.device)[None, :]
    src = torch.where(p >= 0, torch.remainder(p, oldcap), 0)
    dst = torch.where(p >= 0, torch.remainder(p, newcap), newcap)

    def grow(a):
        new = torch.zeros((l, b, newcap + 1, h, hd), dtype=a.dtype,
                          device=a.device)
        for i in range(b):
            ring_index_copy_(new[:, i], 1, dst[i], a[:, i][:, src[i]])
        return new[:, :, :newcap].contiguous()

    return dict(tr_state, k=grow(tr_state["k"]), v=grow(tr_state["v"]))


def _grown(mimi_state, cap: int):
    """A Mimi streaming state whose rings hold ``cap`` slots."""
    tr = mimi_state["transformer"]
    if tr["k"].shape[2] == cap:
        return mimi_state
    return dict(mimi_state, transformer=_grow_rings(
        tr, mimi_state["offset"], cap))


class _OfflineMimi:
    """The batched Mimi phases of the offline scans: every frame of a clip
    through ``encode_step`` (or ``decode_step``) one chunk of
    ``transformer_context // frames_per_step`` frames a call, on
    ``_offline_mimi``'s rings."""

    def __init__(self, mimi: MimiModel, dtype):
        self.chunk = max(mimi.cfg.transformer_context
                         // mimi.cfg.frames_per_step, 1)
        self.model = _offline_mimi(mimi, self.chunk)
        self.cap = self.model.cfg.transformer.mha.cap
        self.dtype = dtype

    def encode(self, params, state, audio_frames):
        """audio_frames [N, B, frame_samples] -> (codes [B, N, n_q],
        state)."""
        n, b, fs = audio_frames.shape
        state = _grown(state, self.cap)
        audio_bt = audio_frames.transpose(0, 1)              # [B, N, fs]
        parts = []
        for c0 in range(0, n, self.chunk):
            cs = min(self.chunk, n - c0)
            flat = audio_bt[:, c0:c0 + cs].reshape(b, cs * fs)
            codes, state = self.model.encode_step(params, state,
                                                  flat.to(self.dtype))
            parts.append(codes)
        return torch.cat(parts, dim=1), state

    def decode(self, params, state, codes):
        """codes [B, N, n_q] -> (audio [N, B, frame_samples] f32,
        state)."""
        b, n = codes.shape[:2]
        state = _grown(state, self.cap)
        parts = []
        for c0 in range(0, n, self.chunk):
            cs = min(self.chunk, n - c0)
            wav, state = self.model.decode_step(params, state,
                                                codes[:, c0:c0 + cs])
            parts.append(wav.reshape(b, cs, -1))
        return torch.cat(parts, dim=1).transpose(0, 1).float(), state


def _mimi_codes(tokens, mimi_n_q: int):
    """Generated audio tokens [..., dep_q] as Mimi codes [..., mimi_n_q]:
    -1/-2 -> 0, the other books padded with 0."""
    codes = torch.where(tokens < 0, torch.zeros_like(tokens), tokens)
    dep_q = codes.shape[-1]
    if dep_q < mimi_n_q:
        pad = torch.zeros(codes.shape[:-1] + (mimi_n_q - dep_q,),
                          dtype=codes.dtype, device=codes.device)
        codes = torch.cat([codes, pad], dim=-1)
    return codes[..., :mimi_n_q]


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
        self.offline = _OfflineMimi(mimi, mimi_dtype)

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
             condition_sum=None, cross_kv=None):
        """audio_in [B, frame_samples] f32 -> (outputs {audio_out [B,
        frame_samples] f32, text [B], valid [B], audio_tokens [B, dep_q]},
        new_state).  ``condition_sum`` and ``cross_kv`` (every layer's
        cross K/V, ``transformer_cross_kv``) condition the LM frame.  The
        states' rings are updated in place."""
        lm_cfg = self.lm_cfg
        n_other = lm_cfg.n_q - lm_cfg.runtime_dep_q
        audio_in = torch.as_tensor(audio_in, device=self.device)
        codes, enc_state = self.mimi.encode_step(
            mimi_params, state["enc"], audio_in.to(self.mimi_dtype))
        other = codes[:, 0, :n_other] if n_other else None
        out, lm_state = lm_gen_step(
            lm_cfg, lm_params, state["lm"], other_audio=other,
            condition_sum=condition_sum, cross_kv=cross_kv, temp=self.temp,
            temp_text=self.temp_text, top_k=self.top_k,
            top_k_text=self.top_k_text, generator=state["generator"])
        # decode our dep_q streams
        wav, dec_state = self.mimi.decode_step(
            mimi_params, state["dec"],
            _mimi_codes(out["audio"], self.mimi.cfg.n_q)[:, None])
        new_state = {"enc": enc_state, "lm": lm_state, "dec": dec_state,
                     "generator": state["generator"]}
        return {"audio_out": wav.float(), "text": out["text"],
                "valid": out["valid"], "audio_tokens": out["audio"]}, \
            new_state

    def lm_frames(self, lm_params, lm_state, other, generator):
        """The offline STS scan's LM phase: ``lm_gen_step`` for each
        frame's other-stream codes ``other`` [N, B, n_other] in order ->
        (texts [N, B], audio_tokens [N, B, dep_q], lm_state)."""
        texts, toks = [], []
        for o in other:
            out, lm_state = lm_gen_step(
                self.lm_cfg, lm_params, lm_state, other_audio=o,
                temp=self.temp, temp_text=self.temp_text, top_k=self.top_k,
                top_k_text=self.top_k_text, generator=generator)
            texts.append(out["text"])
            toks.append(out["audio"])
        return torch.stack(texts), torch.stack(toks), lm_state

    def scan_frames(self, mimi_params, lm_params, state, audio_frames):
        """Offline STS over audio_frames [N, B, frame_samples] f32 in three
        phases: Mimi encode of every frame (a call per chunk), the LM frame
        by frame, Mimi decode of every generated frame (a call per chunk).
        A model without an other stream (n_other = 0) runs ``step`` frame
        by frame instead (``_scan_fused``).  Returns (texts [N, B],
        audio_tokens [N, B, dep_q], audio_out [N, B, frame_samples] f32,
        state)."""
        n_other = self.lm_cfg.n_q - self.lm_cfg.runtime_dep_q
        audio_frames = torch.as_tensor(audio_frames, device=self.device)
        if n_other == 0:
            return self._scan_fused(mimi_params, lm_params, state,
                                    audio_frames)
        codes, enc_state = self.offline.encode(mimi_params, state["enc"],
                                               audio_frames)
        other = codes[..., :n_other].transpose(0, 1)     # [N, B, n_other]
        texts, toks, lm_state = self.lm_frames(lm_params, state["lm"], other,
                                               state["generator"])
        audio_out, dec_state = self.offline.decode(
            mimi_params, state["dec"],
            _mimi_codes(toks, self.mimi.cfg.n_q).transpose(0, 1))
        return texts, toks, audio_out, {
            "enc": enc_state, "lm": lm_state, "dec": dec_state,
            "generator": state["generator"]}

    def _scan_fused(self, mimi_params, lm_params, state, audio_frames):
        """``step`` frame by frame (the scan of a model with no other
        stream)."""
        texts, toks, audio = [], [], []
        for a in audio_frames:
            out, state = self.step(mimi_params, lm_params, state, a)
            texts.append(out["text"])
            toks.append(out["audio_tokens"])
            audio.append(out["audio_out"])
        return torch.stack(texts), torch.stack(toks), torch.stack(audio), \
            state


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
        self.offline = _OfflineMimi(mimi, mimi_dtype)

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
        return {"text": out["sampled_text"], "vad": self._vad(out)}, \
            {"enc": enc_state, "lm": lm_state,
             "generator": state["generator"]}

    def _vad(self, out):
        """The frame's VAD probability [B] f32, zeros without a VAD
        head."""
        vad = out.get("vad")
        if vad is None:
            vad = torch.zeros(out["sampled_text"].shape[0],
                              dtype=torch.float32, device=self.device)
        return vad

    def lm_frames(self, lm_params, lm_state, other, generator):
        """The offline STT scan's LM phase: ``lm_gen_step`` for each
        frame's codes ``other`` [N, B, n_q] in order -> (texts [N, B] (the
        sampled text tokens), vads [N, B] f32, lm_state)."""
        texts, vads = [], []
        for o in other:
            out, lm_state = lm_gen_step(
                self.lm_cfg, lm_params, lm_state, other_audio=o,
                temp_text=self.temp_text, top_k_text=self.top_k_text,
                generator=generator)
            texts.append(out["sampled_text"])
            vads.append(self._vad(out))
        return torch.stack(texts), torch.stack(vads), lm_state

    def scan_frames(self, mimi_params, lm_params, state, audio_frames):
        """Offline transcription of audio_frames [N, B, frame_samples] f32
        in two phases: Mimi encode of every frame (a call per chunk), then
        the LM frame by frame.  Returns (texts [N, B], vads [N, B],
        state)."""
        n_other = self.lm_cfg.n_q - self.lm_cfg.runtime_dep_q
        audio_frames = torch.as_tensor(audio_frames, device=self.device)
        codes, enc_state = self.offline.encode(mimi_params, state["enc"],
                                               audio_frames)
        texts, vads, lm_state = self.lm_frames(
            lm_params, state["lm"], codes[..., :n_other].transpose(0, 1),
            state["generator"])
        return texts, vads, {"enc": enc_state, "lm": lm_state,
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
        wav, dec_state = self.mimi.decode_step(
            mimi_params, state["dec"],
            _mimi_codes(out["audio"], self.mimi.cfg.n_q)[:, None])
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
