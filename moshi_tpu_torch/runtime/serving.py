"""Continuous batching of concurrent full-duplex sessions.

Counterpart of ``moshi_tpu/runtime/serving.py`` (``SessionPool``,
``auto_slots`` and the slot reset): a fixed pool of B session slots runs
one ``STSPipeline.step`` per 80 ms tick for all of them; sessions attach
and detach between ticks, and a slot taken by a new session has its state
rows reset to a fresh session's while the other slots run on.  Per-slot
stream offsets keep the attention, RoPE and the delay cache right for
sessions of different ages.

The reset works in place.  The JAX package keeps a B-wide template state;
here the template is a B = 1 state (for the 7B, one session's rings are
1.57 GB), copied into the chosen slots' rows.  Every row of a fresh
B-wide state equals the B = 1 state, so the result is the same.

``TTSSessionPool`` serves TTS scripts the same way over
``TTSPipeline.step_device``: every slot's text StateMachine runs on the
device, so slots with diverging scripts advance in one frame with one
copy of the outputs to the host per tick (``tick``) or per chunk of
frames (``tick_chunk``).  Scripts are padded to a fixed capacity, so an
attach never changes a shape; young slots are held silent by the delay
masking of ``lm_audio_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from moshi_tpu_torch.models.device_machine import (compile_script,
                                                   init_device_state)
from moshi_tpu_torch.nn.ring import ring_index_copy_
from moshi_tpu_torch.runtime.pipeline import STSPipeline, TTSPipeline


def reset_slots(state, template, slots) -> None:
    """Copy the B = 1 ``template``'s rows into rows ``slots`` of ``state``,
    in place, one copy per leaf for all the slots.  The batch axis is
    known by name: KV-ring leaves named ``k``/``v`` with 3 or more dims
    are stacked [L, B, ...] (axis 1); every other tensor leaf (delay
    cache, offsets, conv carries, FSM rows) is [B, ...] (axis 0); each
    goes through ``ring_index_copy_``, which also takes fp8 rings.  The
    sampling generator is shared and is not reseeded."""
    def walk(leaf, tmpl, name):
        if isinstance(leaf, dict):
            for key, sub in leaf.items():
                walk(sub, tmpl[key], key)
        elif isinstance(leaf, torch.Tensor) and leaf.dim() > 0:
            axis = 1 if name in ("k", "v") and leaf.dim() >= 3 else 0
            idx = torch.tensor(slots, dtype=torch.long, device=leaf.device)
            rows = tmpl.expand(*[len(slots) if d == axis else -1
                                 for d in range(tmpl.dim())])
            ring_index_copy_(leaf, axis, idx, rows)
    walk(state, template, None)


def auto_slots(lm_cfg, weight_bytes: int, device=None, cap: int = 64,
               headroom: float = 0.85) -> int:
    """A pool's slot count from the card's memory: the weights and every
    session's KV rings must fit in ``headroom`` of it (the reference's
    VRAM-aware sizing, moshi-sts.cpp:254-264, applied to sessions)."""
    from moshi_tpu_torch.runtime.memory import suggest_sessions
    n = suggest_sessions(lm_cfg, weight_bytes, device=device,
                         headroom=headroom)
    return int(max(1, min(n, cap)))


@dataclass
class SlotInfo:
    session_id: Optional[str] = None
    frames: int = 0


class SessionPool:
    """Fixed-B pool of full-duplex STS sessions over one frame step.

    >>> pool = SessionPool(pipe, mimi_params, lm_params, batch=8)
    >>> pool.attach("alice"); pool.attach("bob")
    >>> outs = pool.tick({"alice": frame_a, "bob": frame_b})
    """

    def __init__(self, pipe: STSPipeline, mimi_params, lm_params,
                 batch: int, seed: int = 0):
        self.pipe = pipe
        self.mimi_params = mimi_params
        self.lm_params = lm_params
        self.batch = batch
        self.state = pipe.init_state(batch, seed=seed)
        # a fresh session's state rows for slot resets, never mutated
        self._template = pipe.init_state(1, seed=seed)
        self.slots: List[SlotInfo] = [SlotInfo() for _ in range(batch)]
        self._by_session: Dict[str, int] = {}

    # -- session lifecycle ----------------------------------------------
    def attach(self, session_id: str) -> int:
        """Claim the first free slot for ``session_id`` and reset its
        state rows; returns the slot."""
        if session_id in self._by_session:
            raise ValueError(f"duplicate session {session_id!r}")
        for i, s in enumerate(self.slots):
            if s.session_id is None:
                s.session_id = session_id
                s.frames = 0
                self._by_session[session_id] = i
                reset_slots(self.state, self._template, [i])
                return i
        raise RuntimeError("pool full")

    def detach(self, session_id: str):
        i = self._by_session.pop(session_id)
        self.slots[i] = SlotInfo()

    @property
    def active(self) -> int:
        return len(self._by_session)

    # -- frame tick ------------------------------------------------------
    def tick(self, frames: Dict[str, np.ndarray]) -> Dict[str, dict]:
        """One 80 ms tick for all sessions.  ``frames`` maps session id ->
        mic audio [frame_samples]; absent and idle slots get silence.
        Returns session id -> {audio_out [frame_samples] f32, text, valid}.
        The outputs come to the host in one copy."""
        fs = self.pipe.frame_samples
        batch_audio = torch.zeros((self.batch, fs), dtype=torch.float32)
        for sid, frame in frames.items():
            i = self._by_session[sid]
            batch_audio[i] = torch.as_tensor(frame,
                                             dtype=torch.float32).reshape(fs)
        out, self.state = self.pipe.step(self.mimi_params, self.lm_params,
                                         self.state,
                                         batch_audio.to(self.pipe.device))
        host = torch.cat([out["audio_out"].float(),
                          out["text"].float()[:, None],
                          out["valid"].float()[:, None]], dim=1).cpu()
        audio = host[:, :fs].numpy()
        results = {}
        for sid, i in self._by_session.items():
            self.slots[i].frames += 1
            results[sid] = {"audio_out": audio[i], "text": int(host[i, fs]),
                            "valid": bool(host[i, fs + 1])}
        return results


class TTSSessionPool:
    """Fixed-B pool of TTS sessions over one ``step_device`` per tick.

    >>> pool = TTSSessionPool(pipe, machine, mimi_params, lm_params,
    ...                       batch=8, max_tokens=512, max_entries=128)
    >>> pool.attach("req1", entries)
    >>> outs = pool.tick()       # {"req1": {audio_out, valid, done}}
    """

    FINAL_PADDING = 4

    def __init__(self, pipe: TTSPipeline, machine, mimi_params, lm_params,
                 batch: int, max_tokens: int = 512, max_entries: int = 128,
                 seed: int = 0):
        self.pipe = pipe
        self.mimi_params = mimi_params
        self.lm_params = lm_params
        self.batch = batch
        self.pad_to = (max_tokens, max_entries)
        self.dm = pipe.enable_device_fsm(machine)
        dev = pipe.device
        self.script = compile_script([[] for _ in range(batch)], self.dm,
                                     pad_to=self.pad_to, device=dev)
        self.state = pipe.init_state(batch, seed=seed)
        self.mstate = init_device_state(self.dm, self.script)
        # a fresh session's rows for slot resets, never mutated
        self._template = pipe.init_state(1, seed=seed)
        self._mtemplate = init_device_state(self.dm, compile_script(
            [[]], self.dm, pad_to=self.pad_to, device=dev))
        self.slots: List[SlotInfo] = [SlotInfo() for _ in range(batch)]
        self._by_session: Dict[str, int] = {}
        self._delay_steps = pipe.lm_cfg.delay_steps
        self._total: List[Optional[int]] = [None] * batch

    def attach(self, session_id: str, entries) -> int:
        """Claim a free slot for a script (a list of Entry); its state,
        FSM and script rows are reset in place."""
        return self.attach_many({session_id: entries})[session_id]

    def attach_many(self, requests: Dict[str, list]) -> Dict[str, int]:
        """Attach several scripts at once: one script compile, one write
        of the script rows and one reset of the state and FSM rows for all
        of them."""
        free = [i for i, s in enumerate(self.slots) if s.session_id is None]
        if len(requests) > len(free):
            raise RuntimeError("pool full")
        ids = list(requests)
        for sid in ids:
            if sid in self._by_session:
                raise ValueError(f"duplicate session {sid!r}")
        slots = free[: len(ids)]
        rows = compile_script([requests[sid] for sid in ids], self.dm,
                              pad_to=self.pad_to, device=self.pipe.device)
        idx = torch.tensor(slots, dtype=torch.long, device=self.pipe.device)
        for key, v in self.script.items():
            v.index_copy_(0, idx, rows[key])
        reset_slots(self.state, self._template, slots)
        reset_slots(self.mstate, self._mtemplate, slots)
        out = {}
        for sid, i in zip(ids, slots):
            self.slots[i] = SlotInfo(session_id=sid, frames=0)
            self._by_session[sid] = i
            self._total[i] = None
            out[sid] = i
        return out

    def detach(self, session_id: str):
        i = self._by_session.pop(session_id)
        self.slots[i] = SlotInfo()
        self._total[i] = None

    @property
    def active(self) -> int:
        return len(self._by_session)

    def _finish(self, i: int, n: int, end_col) -> tuple:
        """Advance slot i's frame count by n; with ``end_col`` (its
        end_step per frame) set its total once the script ended.  Returns
        (done, frames of this call to keep)."""
        base = self.slots[i].frames
        self.slots[i].frames += n
        if self._total[i] is None:
            hits = np.nonzero(end_col >= 0)[0]
            if hits.size:
                self._total[i] = (int(end_col[hits[0]]) + self._delay_steps
                                  + self.FINAL_PADDING)
        tot = self._total[i]
        done = tot is not None and self.slots[i].frames >= tot
        kept = n if tot is None else max(0, min(n, tot - base))
        return done, kept

    def tick(self) -> Dict[str, dict]:
        """One frame for every slot, its outputs brought to the host in one
        copy.  Returns session id -> {audio_out [frame_samples] f32,
        valid, done}; a done slot (its audio tail drained: end_step +
        delay_steps + FINAL_PADDING frames) detaches."""
        if not self._by_session:
            return {}
        out, self.state, self.mstate = self.pipe.step_device(
            self.mimi_params, self.lm_params, self.state, self.mstate,
            self.script)
        fs = out["audio_out"].shape[-1]
        host = torch.cat([out["audio_out"].float(),
                          out["valid"].float()[:, None],
                          out["end_step"].float()[:, None]], dim=1).cpu()
        results = {}
        for sid in list(self._by_session):
            i = self._by_session[sid]
            done, _ = self._finish(i, 1, host[i:i + 1, fs + 1].numpy())
            results[sid] = {"audio_out": host[i, :fs].numpy(),
                            "valid": bool(host[i, fs]), "done": done}
            if done:
                self.detach(sid)
        return results

    def tick_chunk(self, n: int) -> Dict[str, dict]:
        """``n`` frames for every slot with one copy to the host; sessions
        attach and detach between chunks, and a slot that finishes inside
        a chunk runs on to its end (the surplus frames are dropped here).
        Returns session id -> {audio_out [kept, samples], valid [kept],
        done}."""
        if not self._by_session:
            return {}
        audio, valid, end, self.state, self.mstate = self.pipe.scan_device(
            self.mimi_params, self.lm_params, self.state, self.mstate,
            self.script, n)
        fs = audio.shape[-1]
        host = torch.cat([audio.float(), valid.float()[..., None],
                          end.float()[..., None]], dim=-1).cpu().numpy()
        results = {}
        for sid in list(self._by_session):
            i = self._by_session[sid]
            done, kept = self._finish(i, n, host[:, i, fs + 1])
            results[sid] = {"audio_out": host[:kept, i, :fs],
                            "valid": host[:kept, i, fs].astype(bool),
                            "done": done}
            if done:
                self.detach(sid)
        return results
