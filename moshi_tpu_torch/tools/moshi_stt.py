"""moshi-stt: speech -> text (+ VAD, .srt subtitles).

Counterpart of ``moshi_tpu/tools/moshi_stt.py`` and the reference's
tools/moshi-stt.cpp: audio -> Mimi encode -> the LM -> text tokens and
the VAD probability; ``-s out.srt`` writes VAD-segmented subtitles whose
times are shifted back by the model's audio delay; 8 flush frames after
the input.  ``--scan`` transcribes the whole file offline
(``STTPipeline.scan_frames``: Mimi over the clip a chunk at a time, then
the LM frame by frame), with the same transcript as the frame loop.

Usage: python -m moshi_tpu_torch.tools.moshi_stt -c config.json -i in.wav
"""

import argparse
import time

import numpy as np
import torch

from moshi_tpu_torch import FRAME_SIZE
from moshi_tpu_torch.tools.common import (add_common_args, list_devices,
                                          load_config_arg, load_lm,
                                          load_mimi, load_tokenizer,
                                          read_audio_24k, torch_device)

FLUSH_FRAMES = 8  # moshi-stt.cpp end-of-input flush

DEFAULT_CONFIG = {"model_type": "stt", "dim": 512, "num_layers": 2,
                  "num_heads": 8, "context": 64, "n_q": 8, "dep_q": 0,
                  "card": 2048, "text_card": 4000, "delays": [0] + [1] * 8,
                  "extra_heads_num_heads": 4, "hidden_scale": 4.0,
                  # tiny synthetic model: keep the (normally 5.0 s / 1.0 s)
                  # delays short
                  "stt_config": {"audio_delay_seconds": 0.5,
                                 "audio_silence_prefix_seconds": 0.0}}


def _fmt_ts(sec: float) -> str:
    ms = int(round(sec * 1000))
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=False)
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("-s", "--srt", default=None, help="write .srt subtitles")
    ap.add_argument("--vad-threshold", type=float, default=0.5)
    ap.add_argument("--scan", action="store_true",
                    help="offline mode: Mimi over the whole file a chunk "
                         "at a time, then the LM frame by frame (all "
                         "input frames are known upfront in file mode)")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.list_devices:
        list_devices()
        return 0

    dev = torch_device(args)
    config = load_config_arg(args, DEFAULT_CONFIG)
    args.mimi_file = config.mimi_name     # the codec checkpoint
    args.stt = True
    lm_cfg, lm_params = load_lm(args, config)
    mimi, mimi_params = load_mimi(args, n_q=lm_cfg.n_q)
    tok = load_tokenizer(args, config)

    from moshi_tpu_torch.runtime.pipeline import STTPipeline
    pipe = STTPipeline(mimi, lm_cfg,
                       temp_text=config.lm_gen_config.temp_text,
                       top_k_text=config.lm_gen_config.top_k_text,
                       mimi_dtype=torch.float32 if args.synthetic
                       else torch.bfloat16, device=dev)

    def new_state():
        return pipe.init_state(1, seed=args.seed, lm_params=lm_params)

    state = new_state()

    audio = read_audio_24k(args.input)
    silence_prefix = int(config.stt_config.audio_silence_prefix_seconds
                         * 24_000)
    audio = np.concatenate([np.zeros(silence_prefix, np.float32), audio,
                            np.zeros(FLUSH_FRAMES * FRAME_SIZE, np.float32)])
    n = (len(audio) + FRAME_SIZE - 1) // FRAME_SIZE
    audio = np.pad(audio, (0, n * FRAME_SIZE - len(audio)))

    pieces = []
    srt_segments = []
    seg_tokens = []
    seg_start = None
    pad_id = config.existing_text_padding_id
    # text lags the audio by audio_delay_seconds; subtitle timestamps must
    # subtract that delay (the reference's moshi-stt.cpp does the same)
    stt_frame_delay = int(config.stt_config.audio_delay_seconds * 12.5)
    # every frame's text token is fetched at --window 1 (the reference's
    # per-frame readback); at --window N every N frames, the frames
    # between forced by the state's data flow, the rest after timing
    win = max(1, args.window)
    if args.scan:
        # offline: every input frame is known upfront.  A first pass over
        # the whole input on a throwaway state (kernel builds out of the
        # time), then the timed pass; fetching the text closes the clock.
        frames_arr = torch.from_numpy(
            audio[: n * FRAME_SIZE].reshape(n, 1, FRAME_SIZE)).to(dev)
        t, _, _ = pipe.scan_frames(mimi_params, lm_params, new_state(),
                                   frames_arr)
        t.cpu()
        state = new_state()
        t0 = time.perf_counter()
        texts, vads, state = pipe.scan_frames(mimi_params, lm_params,
                                              state, frames_arr)
        texts = texts.cpu().numpy()                    # D->H closes it
        vads = vads.cpu().numpy()
        dt = time.perf_counter() - t0
        outs = [(texts[f], vads[f]) for f in range(n)]
        n_timed = n
    else:
        outs = []
        t0 = None
        for f in range(n):
            frame = audio[f * FRAME_SIZE:(f + 1) * FRAME_SIZE][None]
            out, state = pipe.step(mimi_params, lm_params, state, frame)
            if f == 0 or (f + 1) % win == 0 or f == n - 1:
                out["text"].cpu()                      # D->H consume
            if f == 0:
                t0 = time.perf_counter()
            outs.append((out["text"], out["vad"]))
        dt = time.perf_counter() - t0 if t0 else 1.0
        n_timed = max(n - 1, 0)
        outs = [(t.cpu().numpy(), v.cpu().numpy()) for t, v in outs]
    for f, (tok_f, vad_f) in enumerate(outs):
        token = int(tok_f[0])
        vad = float(vad_f[0])
        ts = max(f - stt_frame_delay, 0) / 12.5
        if token not in (pad_id, 0, -2) and token >= 0:
            piece = tok.id_to_piece(token) if tok else f"<{token}>"
            pieces.append(piece)
            if seg_start is None:
                seg_start = ts
            seg_tokens.append(piece)
        if vad > args.vad_threshold and seg_tokens:
            srt_segments.append((seg_start, ts, "".join(seg_tokens)
                                 .replace("▁", " ").strip()))
            seg_tokens, seg_start = [], None
    if seg_tokens:
        end = max(n - stt_frame_delay, 0) / 12.5
        srt_segments.append((seg_start, end, "".join(seg_tokens)
                             .replace("▁", " ").strip()))
    text = "".join(pieces).replace("▁", " ").strip()
    print(text)
    if args.srt:
        with open(args.srt, "w") as fh:
            for i, (a, b, line) in enumerate(srt_segments, 1):
                fh.write(f"{i}\n{_fmt_ts(a)} --> {_fmt_ts(b)}\n{line}\n\n")
        print(f"wrote {args.srt}: {len(srt_segments)} segments")
    fps = n_timed / dt
    print(f"bench: {fps:.2f} frames/s ({fps / 12.5:.2f}x realtime)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
