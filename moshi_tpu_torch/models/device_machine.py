"""The text StateMachine on the device: the host FSM of
``models/state_machine.py`` as tensor arithmetic, so that a TTS frame
needs no host round trip between its text and audio phases.

Counterpart of ``moshi_tpu/models/device_machine.py``, the same
transitions as tensor ops on the session's device.  A script compiles once
on the host to flat int32 tensors (the entries' tokens concatenated, and
per entry its start, length, forced padding and lookahead source); the
main queue is a (start, len) cursor into the flat tokens, the lookahead
queue (``second_stream_ahead``) a ring as long as the script.  Every
transition is [B]-vectorized, so sessions with diverging scripts advance
in one step; ``active`` masks slots whose text the host forces this frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.models.state_machine import Entry

NEW_WORD = 0
PAD = 3


@dataclass(frozen=True)
class DeviceMachineConfig:
    """Static FSM parameters (those of ``StateMachine.__init__``)."""
    card: int                       # TokenIds.card = text_card (+1)
    second_stream_ahead: int = 0
    max_padding: int = 8
    initial_padding: int = 2


def compile_script(entries_per_slot: Sequence[Sequence[Entry]],
                   cfg: DeviceMachineConfig,
                   pad_to: tuple[int, int] | None = None, device="cuda"):
    """Entries -> int32 tensors on ``device`` (the card unless the caller
    names the CPU), one row per slot: tok_flat
    [B, N] (every entry's tokens), e_start / e_len / e_pad / e_ahead
    [B, E] (an entry's offset into tok_flat, token count, forced padding,
    and the entry whose tokens feed the lookahead ring when it is popped,
    or -1), n_entries [B].  Padded to the largest slot, or to ``pad_to``
    (max tokens, max entries), which a longer script exceeds with an
    error."""
    device = resolve_device(device)
    rows = []
    for entries in entries_per_slot:
        flat: list[int] = []
        start, length, pad, ahead = [], [], [], []
        nonempty = [i for i, e in enumerate(entries) if e.tokens]
        for i, e in enumerate(entries):
            start.append(len(flat))
            length.append(len(e.tokens))
            pad.append(e.padding)
            flat.extend(e.tokens)
            src = -1
            if cfg.second_stream_ahead:
                later = [j for j in nonempty if j > i]
                k = cfg.second_stream_ahead - 1
                if k < len(later):
                    src = later[k]
            ahead.append(src)
        rows.append((flat, start, length, pad, ahead))
    b = len(rows)
    n = max(1, max(len(r[0]) for r in rows))
    e = max(1, max(len(r[1]) for r in rows))
    if pad_to is not None:
        if n > pad_to[0] or e > pad_to[1]:
            raise ValueError(f"script ({n} tokens, {e} entries) exceeds "
                             f"pool capacity {pad_to}")
        n, e = pad_to

    def padded(seqs, width, fill):
        out = torch.full((b, width), fill, dtype=torch.int32)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = torch.tensor(s, dtype=torch.int32)
        return out.to(device)

    return {
        "tok_flat": padded([r[0] for r in rows], n, 0),
        "e_start": padded([r[1] for r in rows], e, 0),
        "e_len": padded([r[2] for r in rows], e, 0),
        "e_pad": padded([r[3] for r in rows], e, 0),
        "e_ahead": padded([r[4] for r in rows], e, -1),
        "n_entries": torch.tensor([len(r[1]) for r in rows],
                                  dtype=torch.int32, device=device),
    }


def init_device_state(cfg: DeviceMachineConfig, script):
    """Fresh FSM rows (``StateMachine.new_state``) on the script's
    device."""
    b, n = script["tok_flat"].shape
    cap = max(8, n)                 # the ring never holds more than the script
    dev = script["tok_flat"].device

    def full(value, shape=(b,)):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    return {
        "entry_idx": full(0),
        "remaining_padding": full(cfg.initial_padding),
        "forced_padding": full(cfg.initial_padding),
        "end_step": full(-1),
        "q_start": full(0),
        "q_len": full(0),
        "la_buf": full(0, (b, cap)),
        "la_head": full(0),
        "la_len": full(0),
    }


def _w(cond, a, b):
    """torch.where of int32 tensors or Python ints, kept int32."""
    return torch.where(cond, a, b).to(torch.int32)


def device_machine_step(cfg: DeviceMachineConfig, script, st, step, token,
                        active=None):
    """One FSM transition per slot: step [B] (the LM offset), token [B]
    (the sampled text token), active [B] bool (False: the slot's state is
    left as it is and the token passes through).  Returns (output token
    [B] int32, new state)."""
    b, ecap = script["e_start"].shape
    cap = st["la_buf"].shape[1]
    ncap = script["tok_flat"].shape[1]
    dev = token.device
    bi = torch.arange(b, device=dev)
    token = token.to(torch.int32)
    step = step.to(torch.int32)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)

    q_len, q_start = st["q_len"], st["q_start"]
    rem, forced = st["remaining_padding"], st["forced_padding"]
    end_step, entry_idx = st["end_step"], st["entry_idx"]
    la_buf, la_head, la_len = st["la_buf"], st["la_head"], st["la_len"]

    # sanitize, then the padding budgets
    tok = _w((token != NEW_WORD) & (token != PAD), PAD, token)
    tok = _w(q_len > 0, PAD, _w(forced > 0, PAD, _w(rem <= 0, NEW_WORD, tok)))

    # NEW_WORD: pop the next entry
    is_nw = tok == NEW_WORD
    has_entry = entry_idx < script["n_entries"]
    e = entry_idx.clamp(0, ecap - 1).long()
    e_start = script["e_start"][bi, e]
    e_len = script["e_len"][bi, e]
    e_pad = script["e_pad"][bi, e]
    e_ahead = script["e_ahead"][bi, e]
    pop = is_nw & has_entry
    pop_tok = pop & (e_len > 0)
    q_start = _w(pop_tok, e_start, q_start)
    q_len = _w(pop_tok, e_len, q_len)
    rem = _w(pop_tok, cfg.max_padding, rem)
    forced = _w(pop, e_pad, forced)
    entry_idx = _w(pop, entry_idx + 1, entry_idx)
    tok = _w(pop & (e_len == 0), PAD, tok)

    if cfg.second_stream_ahead:
        # append the lookahead source entry's tokens to the ring
        ext = pop_tok & (e_ahead >= 0)
        src = e_ahead.clamp(0, ecap - 1).long()
        s_start = script["e_start"][bi, src]
        s_len = _w(ext, script["e_len"][bi, src], 0)
        k = torch.arange(cap, device=dev)[None, :]
        wpos = (la_head[:, None] + la_len[:, None] + k) % cap
        vals = script["tok_flat"][bi[:, None],
                                  (s_start[:, None] + k).clamp(0, ncap - 1)]
        mask = k < s_len[:, None]
        cur = la_buf[bi[:, None], wpos]
        la_buf = la_buf.clone()
        la_buf[bi[:, None], wpos] = _w(mask, vals, cur)
        la_len = la_len + s_len

    # out of entries
    noent = is_nw & ~has_entry
    tok = _w(noent, PAD, tok)
    if cfg.second_stream_ahead:
        tok = _w(noent & (end_step < 0), NEW_WORD, tok)
    end_step = _w(noent & (end_step < 0), step, end_step)

    # emit
    is_pad = tok == PAD
    rem = _w(is_pad & (rem > 0), rem - 1, rem)
    forced = _w(is_pad & (forced > 0), forced - 1, forced)
    q_front = script["tok_flat"][bi, q_start.clamp(0, ncap - 1).long()]
    out = _w(is_pad, _w(q_len > 0, q_front, PAD), NEW_WORD)
    popped = is_pad & (q_len > 0)
    q_start = _w(popped, q_start + 1, q_start)
    q_len = _w(popped, q_len - 1, q_len)

    if cfg.second_stream_ahead:
        out_is_nw = out == NEW_WORD
        q_front2 = script["tok_flat"][bi, q_start.clamp(0, ncap - 1).long()]
        second = _w(out_is_nw, NEW_WORD, -1)
        out = _w(out_is_nw, _w(q_len > 0, q_front2, PAD), out)
        popped2 = out_is_nw & (q_len > 0)
        q_start = _w(popped2, q_start + 1, q_start)
        q_len = _w(popped2, q_len - 1, q_len)
        la_front = la_buf[bi, la_head.long()]
        pop_la = ~out_is_nw & (la_len > 0)
        second = _w(pop_la, la_front, second)
        la_head = _w(pop_la, (la_head + 1) % cap, la_head)
        la_len = _w(pop_la, la_len - 1, la_len)
        out = (second + 1) * cfg.card + out

    new_st = {
        "entry_idx": entry_idx, "remaining_padding": rem,
        "forced_padding": forced, "end_step": end_step,
        "q_start": q_start, "q_len": q_len,
        "la_buf": la_buf, "la_head": la_head, "la_len": la_len,
    }
    out = _w(active, out, token)
    new_st = {k: _w(active[:, None] if v.dim() == 2 else active, new_st[k],
                    v) for k, v in st.items()}
    return out, new_st


def machine_device_config(machine) -> DeviceMachineConfig:
    """A host StateMachine's parameters."""
    return DeviceMachineConfig(
        card=machine.token_ids.card,
        second_stream_ahead=machine.second_stream_ahead,
        max_padding=machine.max_padding,
        initial_padding=machine.initial_padding)
