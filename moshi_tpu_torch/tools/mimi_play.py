"""mimi-play / mimi-echo.

Counterpart of ``moshi_tpu/tools/mimi_play.py``.  The reference plays
through SDL (tools/mimi-play.cpp) and round-trips mic -> codec ->
speakers (mimi-echo.cpp).  Here:
  * ``mimi_play``: .mimi -> streaming decode, one frame a call -> WAV,
    with the frames/s and realtime report (what live playback needs to
    sustain);
  * ``--echo -i in.wav -o out.wav``: the mimi-echo round trip offline,
    encode -> decode a frame at a time, with the codec's frames/s;
  * ``--echo --realtime-sim``: the round trip through the paced
    frame-FIFO driver (``io/driver.py``) with latency and drop accounting;
  * ``--echo --device [BACKEND]``: live, through an audio device backend
    (``io/audio_device.py``); the report names the backend resolved.
"""

import argparse
import json
import time

import numpy as np

from moshi_tpu_torch import FRAME_SIZE, SAMPLE_RATE
from moshi_tpu_torch.io.media import save_audio as save_wav
from moshi_tpu_torch.io.mimi_file import read_mimi_file
from moshi_tpu_torch.runtime.session import MimiStreamer
from moshi_tpu_torch.tools.common import (add_common_args, list_devices,
                                          load_mimi, read_audio_24k,
                                          torch_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=False)
    ap.add_argument("-o", "--output", default="play.wav")
    ap.add_argument("--echo", action="store_true",
                    help="input is audio; run encode->decode round trip")
    ap.add_argument("--realtime-sim", action="store_true",
                    help="(with --echo) drive the round trip through "
                         "the async frame-FIFO driver (the mic->codec->"
                         "speakers loop structure of mimi-echo.cpp) "
                         "with latency/drop accounting")
    ap.add_argument("--sim-speed", type=float, default=1.0)
    ap.add_argument("--device", nargs="?", const="auto", default=None,
                    help="(with --echo) run LIVE mic->codec->speakers "
                         "through an audio device backend (mimi-echo.cpp "
                         "over common_sdl.h).  Optional value picks the "
                         "backend (alsa / sounddevice / a registered "
                         "shim); bare --device auto-selects.  --frames "
                         "bounds the session (0 = until stream ends)")
    ap.add_argument("--frames", type=int, default=0,
                    help="(with --device) frames to run, 0 = unbounded")
    ap.add_argument("-n", "--n-q", type=int, default=32)
    ap.add_argument("-m", "--mimi-file",
                    default="tokenizer-e351c8d8-checkpoint125.safetensors")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.list_devices:
        list_devices()
        return 0
    if args.device is not None and not args.echo:
        ap.error("--device is the live mic->codec->speakers loop and "
                 "requires --echo")
    dev = torch_device(args)
    if args.echo and args.device is not None:
        from moshi_tpu_torch.io.audio_device import run_device_loop

        model, params = load_mimi(args, n_q=args.n_q)
        streamer = MimiStreamer(model, params, device=dev)

        def step(frame_np):
            return streamer.decode(streamer.encode(frame_np[None]))[0]

        step(np.zeros(FRAME_SIZE, np.float32))   # build before going live
        streamer.reset()       # the warmup frame must not enter the stream
        name = None if args.device == "auto" else args.device
        rep = run_device_loop(step, name=name, max_frames=args.frames)
        print(json.dumps({"metric": "mimi_echo_live", **rep}))
        return 0
    if args.echo:
        audio = read_audio_24k(args.input)
        n = len(audio) // FRAME_SIZE
        audio = audio[: n * FRAME_SIZE]
        model, params = load_mimi(args, n_q=args.n_q)
        streamer = MimiStreamer(model, params, device=dev)
        if args.realtime_sim:
            from moshi_tpu_torch.io.driver import (CaptureDriver, FrameFIFO,
                                                   PlaybackSink, file_source,
                                                   realtime_loop)

            def step(frame_np):
                return streamer.decode(streamer.encode(frame_np[None]))[0]

            step(audio[:FRAME_SIZE])            # build outside pacing
            fifo = FrameFIFO(FRAME_SIZE, depth=3)
            sink = PlaybackSink()
            cap = CaptureDriver(file_source(audio[FRAME_SIZE:]), fifo,
                                pace=0.08 / max(args.sim_speed, 1e-6)
                                ).start()
            rep = realtime_loop(fifo, step, sink)
            cap.join(1.0)
            save_wav(args.output, sink.audio(), SAMPLE_RATE)
            print(json.dumps({"metric": "mimi_echo_realtime_sim", **rep,
                              "sim_speed": args.sim_speed}))
            return 0
        out = []
        t0 = None
        for i in range(n):
            frame = audio[i * FRAME_SIZE:(i + 1) * FRAME_SIZE][None]
            codes = streamer.encode(frame)
            out.append(streamer.decode(codes)[0])
            if i == 0:
                t0 = time.perf_counter()
        dt = time.perf_counter() - t0 if n > 1 else 1.0
        fps = (n - 1) / dt
        save_wav(args.output, np.concatenate(out), SAMPLE_RATE)
        print(f"echo: {n} frames, {fps:.2f} frames/s "
              f"({fps / 12.5:.2f}x realtime), wrote {args.output}")
        return 0
    codes = read_mimi_file(args.input)
    model, params = load_mimi(args, n_q=codes.shape[1])
    streamer = MimiStreamer(model, params, device=dev)
    out = []
    t0 = None
    for i in range(codes.shape[0]):
        out.append(streamer.decode(codes[None, i:i + 1].astype(np.int32))[0])
        if i == 0:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0 if codes.shape[0] > 1 else 1.0
    fps = (codes.shape[0] - 1) / dt
    save_wav(args.output, np.concatenate(out), SAMPLE_RATE)
    print(f"play: {codes.shape[0]} frames, {fps:.2f} frames/s "
          f"({fps / 12.5:.2f}x realtime), wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
