"""moshi-sts: full-duplex speech-to-speech.

Counterpart of ``moshi_tpu/tools/moshi_sts.py`` and the reference's
tools/moshi-sts.cpp: input audio -> Mimi encode -> the LM (the other
stream) -> our audio tokens -> Mimi decode -> output audio, with the text
transcript; ``--bench`` runs 125 distinct dithered-silence frames and
reports frames/s (frame 0 left out of the time); ``--realtime-sim`` goes
through the paced frame-FIFO driver; ``--device`` runs live through an
audio backend (its report names the backend resolved; ``--bench`` with
``--device`` is refused); ``--dump-frame`` records one frame's capture
taps.  Each frame is ``STSPipeline.step`` on the card.

Usage: python -m moshi_tpu_torch.tools.moshi_sts -c config.json -i in.wav
           -o out.wav
       python -m moshi_tpu_torch.tools.moshi_sts --synthetic --bench
"""

import argparse
import json
import time

import numpy as np
import torch

from moshi_tpu_torch import FRAME_SIZE, SAMPLE_RATE
from moshi_tpu_torch.tools.common import (add_common_args, list_devices,
                                          load_config_arg, load_lm,
                                          load_mimi, load_tokenizer,
                                          read_audio_24k, torch_device)

BENCH_FRAMES = 125  # moshi-sts.cpp --bench

# 7B moshi layout scaled down unless a real config is given
DEFAULT_CONFIG = {"model_type": "moshi", "dim": 512, "num_layers": 2,
                  "num_heads": 8, "context": 128, "n_q": 16, "dep_q": 8,
                  "card": 2048, "text_card": 4000,
                  "delays": [0, 0] + [1] * 7 + [0] + [1] * 7,
                  "depformer_dim": 256, "depformer_num_layers": 2,
                  "hidden_scale": 4.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", default=None)
    ap.add_argument("-o", "--output", default="sts.wav")
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--frames", type=int, default=None,
                    help=f"frame budget (default {BENCH_FRAMES} for "
                         "--bench, unbounded for --device)")
    ap.add_argument("--realtime-sim", action="store_true",
                    help="drive the loop through the async frame-FIFO "
                         "driver (common_sdl.h analog) with a paced "
                         "capture thread; reports sustained fps, "
                         "latency p50/p99 vs the 80 ms budget, drops")
    ap.add_argument("--device", nargs="?", const="auto", default=None,
                    help="LIVE full-duplex mic->moshi->speakers through "
                         "an audio device backend (moshi-sts.cpp over "
                         "common_sdl.h; backends: alsa / sounddevice / "
                         "a registered shim; bare --device auto-picks). "
                         "--frames bounds the session, 0 = until the "
                         "stream ends")
    ap.add_argument("--sim-speed", type=float, default=1.0,
                    help="capture pacing speedup for --realtime-sim "
                         "(2.0 = frames arrive every 40 ms)")
    ap.add_argument("--dump-frame", default=None, metavar="PATH",
                    help="run ONE frame with every capture tap recorded "
                         "and write PATH.npz + PATH.json (tensors, "
                         "execution order, caller provenance): the "
                         "reference's GraphDumper")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.bench and args.device is not None:
        ap.error("--bench runs file frames and --device a live session; "
                 "give one of them")
    if args.frames is None:
        # a live conversation must not silently end at the bench budget
        args.frames = 0 if args.device is not None else BENCH_FRAMES
    if args.list_devices:
        list_devices()
        return 0

    dev = torch_device(args)
    config = load_config_arg(args, DEFAULT_CONFIG)
    args.mimi_file = config.mimi_name     # the codec checkpoint
    lm_cfg, lm_params = load_lm(args, config)
    if dev.type == "cuda":
        # shrink the context to fit the card's memory before the state is
        # built (the reference's moshi-sts.cpp does so before load)
        from moshi_tpu_torch.runtime.memory import auto_shrink_context
        from moshi_tpu_torch.runtime.synth import tree_nbytes
        lm_cfg, shrunk, ctx = auto_shrink_context(
            lm_cfg, tree_nbytes(lm_params), device=dev)
        if shrunk:
            print(f"context shrunk to {ctx} to fit device memory")
    mimi, mimi_params = load_mimi(args, n_q=lm_cfg.n_q)
    tok = load_tokenizer(args, config)

    from moshi_tpu_torch.runtime.pipeline import STSPipeline
    gen_cfg = config.lm_gen_config
    pipe = STSPipeline(mimi, lm_cfg, temp=gen_cfg.temp,
                       temp_text=gen_cfg.temp_text, top_k=gen_cfg.top_k,
                       top_k_text=gen_cfg.top_k_text,
                       mimi_dtype=torch.float32 if args.synthetic
                       else torch.bfloat16, device=dev)

    def new_state():
        return pipe.init_state(1, seed=args.seed, lm_params=lm_params)

    state = new_state()

    if args.bench or not args.input:
        # dithered silence: DISTINCT buffers per frame, so that no frame's
        # result can stand in for another's
        rng = np.random.default_rng(args.seed)
        audio = (rng.standard_normal(args.frames * FRAME_SIZE) * 1e-4
                 ).astype(np.float32)
    else:
        audio = read_audio_24k(args.input)
        n = (len(audio) + FRAME_SIZE - 1) // FRAME_SIZE
        audio = np.pad(audio, (0, n * FRAME_SIZE - len(audio)))
    n = len(audio) // FRAME_SIZE

    if args.dump_frame:
        from moshi_tpu_torch.utils.capture import recording
        with recording() as rec:
            out, state = pipe.step(mimi_params, lm_params, state,
                                   audio[:FRAME_SIZE][None])
            out["audio_out"].cpu()
        rec.dump_graph(args.dump_frame)
        print(f"dumped {len(rec.order)} tensors "
              f"({len(rec.values)} taps) to {args.dump_frame}.npz/.json")
        return 0

    transcript = []
    pad_id = config.existing_text_padding_id

    def emit_text(token: int):
        if token not in (pad_id, 0, -2) and token >= 0 and tok:
            transcript.append(tok.id_to_piece(token))

    st_box = [state]

    def step_frame(frame_np):
        out, st_box[0] = pipe.step(mimi_params, lm_params, st_box[0],
                                   frame_np[None])
        emit_text(int(out["text"][0]))                 # D->H fetch
        return out["audio_out"][0].cpu().numpy()

    if args.device is not None:
        # LIVE full duplex (the reference's moshi-sts.cpp main loop over
        # common_sdl.h device streams): device capture -> FIFO -> frame
        # step -> device playback, drop/latency accounting vs 80 ms
        from moshi_tpu_torch.io.audio_device import run_device_loop
        step_frame(np.zeros(FRAME_SIZE, np.float32))   # build first
        # the warmup frame must not leak into the live session: fresh
        # streaming state, empty transcript
        st_box[0] = new_state()
        transcript.clear()
        name = None if args.device == "auto" else args.device
        rep = run_device_loop(step_frame, name=name, max_frames=args.frames)
        print(json.dumps({"metric": "sts_live_device", **rep}))
        if transcript:
            print("".join(transcript).replace("▁", " ").strip())
        return 0

    if args.realtime_sim:
        # async-driver loop (common_sdl.h structure): paced capture
        # thread -> FIFO -> per-frame compute -> playback accounting
        from moshi_tpu_torch.io.driver import (CaptureDriver, FrameFIFO,
                                               PlaybackSink, file_source,
                                               realtime_loop)
        # frame 0 outside the paced loop (kernel builds on first launch)
        step_frame(audio[:FRAME_SIZE])
        fifo = FrameFIFO(FRAME_SIZE, depth=3)
        sink = PlaybackSink(keep_audio=not args.bench)
        cap = CaptureDriver(file_source(audio[FRAME_SIZE:]), fifo,
                            pace=0.08 / max(args.sim_speed, 1e-6)).start()
        rep = realtime_loop(fifo, step_frame, sink)
        cap.join(1.0)
        fps = rep.get("sustained_fps", 0.0)
        out_parts = [sink.audio()]
        print(json.dumps({"metric": "sts_realtime_sim", **rep,
                          "sim_speed": args.sim_speed}))
    else:
        # the reference's tight loop (moshi-sts.cpp --bench): every
        # frame's text token is fetched and consumed
        out_parts = []
        t0 = None
        for f in range(n):
            frame = audio[f * FRAME_SIZE:(f + 1) * FRAME_SIZE][None]
            out, state = pipe.step(mimi_params, lm_params, state, frame)
            emit_text(int(out["text"][0]))             # D->H fetch
            if f == 0:
                t0 = time.perf_counter()   # frame 0 (kernel builds) out
            if not args.bench:
                out_parts.append(out["audio_out"][0].cpu().numpy())
        dt = time.perf_counter() - t0 if t0 else 1.0
        frames_timed = max(n - 1, 0)
        fps = frames_timed / dt if frames_timed else 0.0

    if not args.bench:
        from moshi_tpu_torch.io.media import save_audio as save_wav
        wav = np.concatenate(out_parts)
        save_wav(args.output, wav, SAMPLE_RATE)
        print(f"wrote {args.output}: {len(wav) / SAMPLE_RATE:.2f}s")
    if transcript:
        print("".join(transcript).replace("▁", " ").strip())
    print(f"bench: {fps:.2f} frames/s ({fps / 12.5:.2f}x realtime), "
          f"{n} frames")
    if args.bench:
        print(json.dumps({"metric": "sts_frames_per_sec",
                          "value": round(fps, 2), "unit": "frames/s"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
