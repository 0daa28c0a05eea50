"""Text pacing StateMachine and script tokenization (host-side FSM).

A copy of ``moshi_tpu/models/state_machine.py`` (pure
Python; the port imports nothing of the JAX package).

Behavioral parity with reference src/moshi/models/lm.h:
  * TokenIds (lm.h:5-18): new_word=0, main=1, other=2, pad=3, zero=-1,
    ungenerated=-2.
  * StateMachine.process (lm.h:102-193): per-step decision PAD vs NEW_WORD
    vs feed-queued-token under forced/remaining padding budgets; optional
    second_stream_ahead muxes a lookahead word stream into the same token
    as (second + 1) * card + output.
  * script_to_entries (lm.h:198-244): script -> word Entries with
    speaker-turn tokens on line alternation and padding_between;
    <break time="Ns"/> produces a pure-padding entry (the reference parses
    breaks in the streaming tokenizer FSM, moshi.cpp:489-594).

This runs on the host per frame (scalar FSM over a word queue, inherently
sequential and input-driven); the device-side delay cache and sampling
stay in-jit (models/lm.py).
"""

from __future__ import annotations

import re
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence


@dataclass(frozen=True)
class TokenIds:
    card: int = 8001
    new_word: int = 0
    main: int = 1
    other: int = 2
    pad: int = 3
    zero: int = -1
    ungenerated: int = -2


@dataclass
class Entry:
    tokens: List[int]
    text: str = ""
    padding: int = 0


@dataclass
class MachineState:
    remaining_padding: int
    forced_padding: int
    end_step: int = -1
    entries: Deque[Entry] = field(default_factory=deque)
    queued: Deque[int] = field(default_factory=deque)
    lookahead_queued: Deque[int] = field(default_factory=deque)

    def is_empty(self) -> bool:
        return not (self.entries or self.queued or self.lookahead_queued)

    def get_tokens_ahead(self, lookahead: int) -> List[int]:
        for entry in self.entries:
            if not entry.tokens:
                continue
            lookahead -= 1
            if lookahead == 0:
                return entry.tokens
        return []


class StateMachine:
    def __init__(self, text_card: int, second_stream_ahead: int = 0,
                 max_padding: int = 8, initial_padding: int = 2,
                 logging: bool = False):
        self.token_ids = TokenIds(card=text_card)
        self.second_stream_ahead = second_stream_ahead
        self.max_padding = max_padding
        self.initial_padding = initial_padding
        # word-timing log (reference lm.h:122-129): on each NEW_WORD,
        # print the word text and seconds since the previous word
        import os
        self.logging = logging or bool(os.environ.get("MOSHI_TPU_WORD_LOG"))
        self._last_word_time = 0.0

    def new_state(self, entries: Optional[Sequence[Entry]] = None) -> MachineState:
        return MachineState(
            remaining_padding=self.initial_padding,
            forced_padding=self.initial_padding,
            entries=deque(entries or []),
        )

    def reset_state(self, state: MachineState):
        state.remaining_padding = self.initial_padding
        state.forced_padding = self.initial_padding
        state.end_step = -1
        state.entries.clear()
        state.queued.clear()
        state.lookahead_queued.clear()

    def process(self, step: int, state: MachineState, token: int) -> int:
        ids = self.token_ids
        if token not in (ids.new_word, ids.pad):
            token = ids.pad
        if state.queued:
            token = ids.pad
        elif state.forced_padding > 0:
            token = ids.pad
        elif state.remaining_padding <= 0:
            token = ids.new_word

        if token == ids.new_word:
            if state.entries:
                entry = state.entries.popleft()
                if self.logging:
                    import time
                    now = time.monotonic()
                    last = self._last_word_time or now
                    print(f'"{entry.text}" {now - last:.4f}', flush=True)
                    self._last_word_time = now
                if entry.tokens:
                    state.queued.extend(entry.tokens)
                    if self.second_stream_ahead:
                        state.lookahead_queued.extend(
                            state.get_tokens_ahead(self.second_stream_ahead))
                    state.remaining_padding = self.max_padding
                else:
                    token = ids.pad
                state.forced_padding = entry.padding
            else:
                token = ids.pad
                if self.second_stream_ahead and state.end_step < 0:
                    token = ids.new_word
                if state.end_step < 0:
                    state.end_step = step

        output = ids.new_word
        if token == ids.pad:
            if state.remaining_padding > 0:
                state.remaining_padding -= 1
            if state.forced_padding > 0:
                state.forced_padding -= 1
            output = state.queued.popleft() if state.queued else ids.pad
        elif token == ids.new_word:
            output = ids.new_word
        elif token == ids.zero:
            output = token

        if self.second_stream_ahead:
            second = -1
            if output == ids.new_word:
                second = ids.new_word
                output = state.queued.popleft() if state.queued else ids.pad
            elif state.lookahead_queued:
                second = state.lookahead_queued.popleft()
            output = (second + 1) * ids.card + output
        return output


_BREAK_RE = re.compile(r'<break\s+time="([0-9]+(?:\.[0-9]*)?)s"\s*/?>')


def script_to_entries(tokenizer, token_ids: TokenIds, frame_rate: float,
                      script: Sequence[str], multi_speaker: bool = True,
                      padding_between: int = 0) -> List[Entry]:
    """tokenizer: any object with .encode(str) -> List[int]."""
    entries: List[Entry] = []
    last_speaker = -99
    speaker_tokens = [token_ids.main, token_ids.other]
    for idx, init_line in enumerate(script):
        line = init_line.replace(":", " ").replace("(", "").replace(")", "")
        # <break time="Ns"/> -> pure-padding entry (moshi.cpp:557-585)
        parts: List[str] = []
        pos = 0
        first_content = True
        for m in _BREAK_RE.finditer(line):
            parts.append(line[pos:m.start()])
            parts.append(f"\0BREAK:{m.group(1)}\0")
            pos = m.end()
        parts.append(line[pos:])
        text = "".join(parts)
        for chunk in text.split("\0"):
            if chunk.startswith("BREAK:"):
                seconds = float(chunk[6:])
                entries.append(Entry([], f'<break time="{seconds}s"/>',
                                     padding=int(seconds * frame_rate)))
                continue
            for word in chunk.split():
                tokens = list(tokenizer.encode(word))
                if first_content:
                    speaker = idx % 2
                    if multi_speaker and last_speaker != speaker:
                        last_speaker = speaker
                        tokens = [speaker_tokens[speaker]] + tokens
                    first_content = False
                padding = 0
                if padding_between > 0:
                    padding = max(padding_between + len(tokens) - 1, 0)
                entries.append(Entry(tokens, word, padding))
    return entries
