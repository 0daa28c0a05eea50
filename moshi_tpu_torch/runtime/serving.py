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
``TTSSessionPool`` is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from moshi_tpu_torch.runtime.pipeline import STSPipeline


def reset_slots(state, template, slots) -> None:
    """Copy the B = 1 ``template``'s rows into rows ``slots`` of ``state``,
    in place.  The batch axis is known by name: KV-ring leaves named
    ``k``/``v`` with 3 or more dims are stacked [L, B, ...] (axis 1);
    every other tensor leaf (delay cache, offsets, conv carries) is
    [B, ...] (axis 0).  The sampling generator is shared and is not
    reseeded."""
    def walk(leaf, tmpl, name):
        if isinstance(leaf, dict):
            for key, sub in leaf.items():
                walk(sub, tmpl[key], key)
        elif isinstance(leaf, torch.Tensor) and leaf.dim() > 0:
            if name in ("k", "v") and leaf.dim() >= 3:
                for s in slots:
                    leaf[:, s].copy_(tmpl[:, 0])
            else:
                for s in slots:
                    leaf[s].copy_(tmpl[0])
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
