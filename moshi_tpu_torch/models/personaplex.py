"""PersonaPlex session priming: voice prompt and system prompt, then the
STS frame.

Counterpart of ``moshi_tpu/models/personaplex.py`` (the reference's
lm.h:983-1134 and moshi.cpp:789-849):

  * ``PROMPT_TOKENS``: the fixed 17-token frame template (text 3, 8 moshi
    codes, 8 input codes) of the silence and system-prompt frames;
  * a voice prompt from a voice file: ``voice.embeddings`` [T, dim] fed
    straight through the temporal transformer (no token embedding), then
    the delay cache overwritten from ``voice.cache``;
  * or a voice prompt from audio: Mimi codes replayed as forced frames in
    the template's slots;
  * the system prompt: "<system> ... <system>" text tokens in template
    frames, with 6 silence frames on each side;
  * PersonaPlex models run 8 of their 16 depformer steps
    (``LMConfig.runtime_dep_q``; ``models/lm.py`` ``_per_step_weights``
    takes views of the first 8 steps' weights, no copy).

The JAX package runs the priming as compiled scans, chunked to a few fixed
lengths to bound its compiles, and XLA drops the work whose results are
discarded.  Here the frames run in a Python loop, so that work is left
out by hand:

  * a voice-embedding frame runs the temporal stack only: the reference's
    out_norm, text head and depformer feed tokens that the delay cache
    overwrite discards;
  * a forced frame writes the frame into the delay cache, builds the
    input, embeds it and runs the temporal stack.  ``lm_gen_step`` with a
    forced frame writes no generated token (``lm_audio_step``'s
    ``provided``), so its text and depformer sampling change nothing in
    the state.  The sampling arguments are taken for the JAX package's
    signatures and have no effect.

The primed state (rings, delay cache, offset) is the JAX package's
``prime_frames`` result; the sampling generator is not consumed.  At the
7B a priming frame launches K1 64, K5 32, K3 32 and K4 1 on the card.  A
session then runs ``runtime/pipeline.py`` ``STSPipeline`` with Mimi at the
LM's n_q and ``state["lm"]`` the primed state (see README).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from moshi_tpu_torch.models.lm import (LMConfig, build_input_frame,
                                       embed_frame, write_stream_tokens)
from moshi_tpu_torch.nn.layers import linear, rms_norm
from moshi_tpu_torch.nn.transformer import transformer_forward

# lm.h:983-987
PROMPT_TOKENS = [
    3,                                                   # text
    948, 243, 1178, 546, 1736, 1030, 1978, 2008,         # moshi stream
    430, 1268, 381, 1611, 1095, 1495, 56, 472,           # input stream
]


def forward_embedding(cfg: LMConfig, params, kv_state, embeddings, offset):
    """The temporal forward from input embeddings [B, T, dim] (lm.h
    moshi_lmmodel_forward_embedding) -> (h [B, T, dim] after out_norm,
    text logits [B, T, text_card] f32, kv_state written in place)."""
    h, new_kv = transformer_forward(cfg.transformer, params["transformer"],
                                    kv_state, embeddings, offset)
    h = rms_norm(params["out_norm"], h)
    logits = linear(params["text_linear"], h, out_dtype=torch.float32)
    return h, logits, new_kv


def prime_with_voice_embeddings(cfg: LMConfig, params, state,
                                embeddings: np.ndarray, cache: np.ndarray):
    """Voice-file priming (lm.h:998-1052): each embedding frame through the
    temporal stack (which fills the KV rings), then the delay cache
    replaced by the shipped one.  embeddings [T, dim] (voice.embeddings);
    cache [CT, K] (voice.cache, stored [K, CT] in the file: see
    ``load_voice_file``)."""
    kv, offset = state["transformer"], state["offset"]
    b = offset.shape[0]
    dev = offset.device
    emb = torch.as_tensor(np.asarray(embeddings, np.float32), device=dev)
    for t in range(emb.shape[0]):
        x = emb[t].expand(b, 1, emb.shape[1]).contiguous()
        _, kv = transformer_forward(cfg.transformer, params["transformer"],
                                    kv, x, offset)
        offset = offset + 1
    cache_arr = torch.as_tensor(np.asarray(cache, np.int64), device=dev)
    if tuple(cache_arr.shape) != tuple(state["cache"].shape[1:]):
        raise ValueError(f"voice cache {tuple(cache_arr.shape)} vs the "
                         f"delay cache {tuple(state['cache'].shape[1:])}")
    return {"transformer": kv,
            "cache": cache_arr[None].repeat(b, 1, 1),
            "offset": offset}


def prime_frames(cfg: LMConfig, params, state, frames):
    """Forced PROMPT_TOKENS-style frames: frames [T, K] token rows (a host
    list or array), each broadcast over the state's batch, written into
    the delay cache and run through the embedding and the temporal stack;
    the offset advances one a frame."""
    frames = np.asarray(frames, np.int64)[:, : cfg.num_codebooks]
    cache, offset = state["cache"], state["offset"]
    kv = state["transformer"]
    b = offset.shape[0]
    rows = torch.as_tensor(frames, device=offset.device)
    for row in rows:
        cache = write_stream_tokens(cfg, cache, offset,
                                    row[None].expand(b, -1), 0)
        x = embed_frame(cfg, params, build_input_frame(cfg, cache, offset))
        _, kv = transformer_forward(cfg.transformer, params["transformer"],
                                    kv, x, offset)
        offset = offset + 1
    return {"transformer": kv, "cache": cache, "offset": offset}


def prime_step(cfg: LMConfig, params, state, tokens: List[int]):
    """One forced PROMPT_TOKENS-style frame (a full frame provided)."""
    return prime_frames(cfg, params, state, [tokens])


def _audio_prompt_frames(audio_codes: List[List[int]]) -> np.ndarray:
    """lm.h:1053-1076: the voice sample's Mimi codes in the moshi-stream
    slots of the PROMPT_TOKENS template."""
    dep_q = 8  # personaplex
    rows = []
    for codes in audio_codes:
        tokens = list(PROMPT_TOKENS)
        for j in range(min(dep_q, len(codes))):
            tokens[j + 1] = int(codes[j])
        rows.append(tokens)
    return np.asarray(rows, np.int64)


def prime_with_audio(cfg: LMConfig, params, state,
                     audio_codes: List[List[int]]):
    """Raw-audio voice prompt (lm.h:1053-1076): the voice sample's Mimi
    codes replayed as forced frames."""
    return prime_frames(cfg, params, state,
                        _audio_prompt_frames(audio_codes))


def prime_system_prompts(cfg: LMConfig, params, state,
                         text_prompt_tokens: List[int],
                         voice_embeddings: Optional[np.ndarray] = None,
                         voice_cache: Optional[np.ndarray] = None,
                         voice_audio_codes=None,
                         silence_frames: int = 6):
    """The whole priming (lm.h:1120-1134): the voice prompt, silence
    frames, the system prompt's text frames, silence frames."""
    rows = []
    if voice_embeddings is not None and voice_cache is not None:
        state = prime_with_voice_embeddings(cfg, params, state,
                                            voice_embeddings, voice_cache)
    elif voice_audio_codes:
        rows.append(_audio_prompt_frames(voice_audio_codes))
    silence = np.asarray([PROMPT_TOKENS] * silence_frames, np.int64)
    text_rows = np.asarray([PROMPT_TOKENS] * len(text_prompt_tokens),
                           np.int64)
    if len(text_prompt_tokens):
        text_rows[:, 0] = np.asarray(text_prompt_tokens, np.int64)
    rows += [silence, text_rows, silence]
    frames = np.concatenate([r for r in rows if len(r)], axis=0)
    return prime_frames(cfg, params, state, frames)


def load_voice_file(path: str, cfg: Optional[LMConfig] = None):
    """A PersonaPlex voice file (.safetensors or .gguf) -> (embeddings
    [T, dim] f32 | None, cache [CT, K] int32 | None, speaker_wavs | None).
    The cache ships [K, CT] (lm.h:1038-1045); GGUF voices as
    moshi.cpp:789-836 reads them.  With ``cfg`` the cache is oriented by
    its stream count K = cfg.num_codebooks, and a shape that is neither
    [CT, K] nor [K, CT] raises; without it the longer axis is taken for
    CT, which misreads a voice with CT >= K stored [K, CT]."""
    if path.endswith(".gguf"):
        from moshi_tpu_torch.runtime.loader import _GGUFAdapter
        st = _GGUFAdapter(path, "cpu")
    else:
        from moshi_tpu_torch.io.safetensors import SafeTensors
        st = SafeTensors(path)
    emb = cache = wavs = None
    try:
        if "voice.embeddings" in st:
            e = np.asarray(st["voice.embeddings"], np.float32)
            emb = e.reshape(e.shape[0], -1)
        if "voice.cache" in st:
            c = np.asarray(st["voice.cache"])
            if cfg is not None:
                k = cfg.num_codebooks
                if c.shape[1] == k and c.shape[0] != k:
                    cache = c.astype(np.int32)             # already [CT, K]
                elif c.shape[0] == k:
                    cache = c.T.astype(np.int32)           # stored [K, CT]
                else:
                    raise ValueError(
                        f"voice.cache shape {c.shape} matches neither "
                        f"[CT, {k}] nor [{k}, CT] for this model")
            else:
                cache = (c.T if c.shape[0] > c.shape[1] else c).astype(
                    np.int32)
        if "voice.speaker_wavs" in st:
            wavs = np.asarray(st["voice.speaker_wavs"], np.float32)
    finally:
        st.close()
    return emb, cache, wavs
