"""moshi-tts: text -> speech.

Counterpart of ``moshi_tpu/tools/moshi_tts.py`` and the reference's
tools/moshi-tts.cpp: script -> word entries -> StateMachine-paced LM
generation -> Mimi decode -> WAV; ``--bench`` runs the fixed benchmark
text with seed 0 and greedy sampling and reports frames/s and tokens/s.
Four generators:
  * the default: the device FSM (``TTSPipeline.step_device``), one frame
    a step, the end marker fetched every ``--window`` frames;
  * ``--host-fsm``: the host StateMachine (``TTSPipeline.step``), the
    sampled text token fetched every frame;
  * ``--interactive``: the host FSM fed while it runs, a reader thread
    queueing stdin's lines as words;
  * ``--scan``: offline, ``TTSPipeline.scan_device`` ``SCAN_CHUNK``
    frames a call with one fetch of the end marker a chunk, topped up
    when the end lands near a chunk's tail.
A voice conditions cross-attention models (a .safetensors with
voice.speaker_wavs, through the checkpoint's conditioners and every
layer's cross K/V) and prefixes the others (a speaker wav, Mimi-encoded).

Usage: python -m moshi_tpu_torch.tools.moshi_tts -c config.json "Hello"
       python -m moshi_tpu_torch.tools.moshi_tts --synthetic --bench
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from moshi_tpu_torch import FRAME_SIZE, SAMPLE_RATE
from moshi_tpu_torch.models.state_machine import (StateMachine, TokenIds,
                                                  script_to_entries)
from moshi_tpu_torch.tools.common import (add_common_args, list_devices,
                                          load_config_arg, load_lm,
                                          load_mimi, load_tokenizer,
                                          torch_device)

# moshi-tts.cpp --bench uses a fixed paragraph; any fixed text gives
# comparable frames/s numbers
BENCH_TEXT = ("The quick brown fox jumps over the lazy dog. "
              "She sells sea shells by the sea shore.")
SCAN_CHUNK = 64      # frames of one --scan call
FINAL_PADDING = 4    # frames generated after the end marker and the delay

DEFAULT_CONFIG = {"model_type": "tts", "dim": 512, "num_layers": 2,
                  "num_heads": 8, "context": 64, "n_q": 8, "dep_q": 8,
                  "card": 2048, "text_card": 4000,
                  "delays": [0] + [0] + [1] * 7, "depformer_dim": 256,
                  "depformer_num_layers": 2, "hidden_scale": 4.0}


class _FakeTokenizer:
    def encode(self, word):
        return [10 + (ord(c) % 200) for c in word[:4]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("text", nargs="*", default=None)
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("-i", "--input", default=None, help="script file")
    ap.add_argument("-o", "--output", default="tts.wav")
    ap.add_argument("--mimi-file", default=None)
    ap.add_argument("--voice", default=None,
                    help="voice file: .safetensors with voice.speaker_wavs "
                         "(cross-attention models) or a speaker wav "
                         "(prefix models)")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--scan", action="store_true",
                    help="offline mode: generate in chunks of frames "
                         "(device FSM; one fetch of the end marker per "
                         "chunk)")
    ap.add_argument("--interactive", action="store_true",
                    help="feed-while-generating: a stdin reader thread "
                         "queues words into the live StateMachine as "
                         "lines arrive (moshi-tts.cpp); generation ends "
                         "after stdin EOF + final padding")
    ap.add_argument("--host-fsm", action="store_true",
                    help="per-frame host StateMachine (the reference's "
                         "on_text-hook structure, one D->H fetch per "
                         "frame) instead of the device FSM")
    ap.add_argument("--max-frames", type=int, default=2000)
    ap.add_argument("--temp", type=float, default=0.6)
    ap.add_argument("--temp-text", type=float, default=0.6)
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.list_devices:
        list_devices()
        return 0

    dev = torch_device(args)
    config = load_config_arg(args, DEFAULT_CONFIG)
    if args.mimi_file:
        config.mimi_name = args.mimi_file
    args.mimi_file = config.mimi_name
    args.tts = True
    if args.bench:
        args.temp = 0.0
        args.temp_text = 0.0
        args.seed = 0

    lm_cfg, lm_params = load_lm(args, config)
    mimi, mimi_params = load_mimi(args, n_q=max(lm_cfg.dep_q, 1))
    tok = load_tokenizer(args, config) or _FakeTokenizer()

    if args.interactive:
        script = []                      # entries arrive from the thread
    elif args.text:
        script = [" ".join(args.text)]
    elif args.input:
        with open(args.input) as fh:
            script = fh.read().splitlines()
    elif args.bench:
        script = [BENCH_TEXT]
    else:
        script = sys.stdin.read().splitlines()

    ids = TokenIds(card=lm_cfg.text_card + 1)
    entries = script_to_entries(tok, ids, 12.5, script, multi_speaker=False,
                                padding_between=1)

    from moshi_tpu_torch.models.lm import UNGENERATED
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    machine = StateMachine(
        text_card=lm_cfg.text_card + 1,
        second_stream_ahead=config.tts_config.second_stream_ahead
        if lm_cfg.demux_second_stream else 0,
        max_padding=8, initial_padding=2)          # the reference's moshi.cpp
    pipe = TTSPipeline(mimi, lm_cfg, temp=args.temp,
                       temp_text=args.temp_text,
                       mimi_dtype=torch.float32 if args.synthetic
                       else torch.bfloat16, device=dev)

    def new_state():
        return pipe.init_state(1, seed=args.seed, lm_params=lm_params)

    # -- voice -----------------------------------------------------------
    condition_sum = cross_kv = None
    text_prefixes: list = []
    audio_prefixes: list = []
    if args.voice and lm_cfg.cross_attention:
        # cross-attention voice conditioning (the reference's moshi.cpp)
        from moshi_tpu_torch.models.personaplex import load_voice_file
        from moshi_tpu_torch.models.tts import (load_conditioners,
                                                voice_condition)
        from moshi_tpu_torch.nn.transformer import transformer_cross_kv
        from moshi_tpu_torch.runtime.loader import _Source
        from moshi_tpu_torch.tools.common import resolve_model_file
        _, _, wavs = load_voice_file(args.voice, lm_cfg)
        if wavs is None:
            raise ValueError(f"{args.voice}: no voice.speaker_wavs")
        src = _Source(dev, str(resolve_model_file(config.moshi_name,
                                                  args.model_dir)))
        try:
            cond = load_conditioners(src, device=dev)
        finally:
            src.close()
        condition_sum, ccross = voice_condition(
            cond, torch.as_tensor(wavs, device=dev))
        cross_kv = transformer_cross_kv(lm_cfg.transformer,
                                        lm_params["transformer"], ccross)
    elif args.voice:
        # voice prefix for models without cross-attention (tts.h)
        from moshi_tpu_torch.models.tts import make_voice_prefix
        from moshi_tpu_torch.runtime.session import MimiStreamer
        from moshi_tpu_torch.tools.common import read_audio_24k
        streamer = MimiStreamer(mimi, mimi_params, device=dev)
        audio = read_audio_24k(args.voice)
        text_prefixes, audio_prefixes = make_voice_prefix(
            lambda a: streamer.encode(a), audio, lm_cfg, lm_cfg.delay_steps)

    def _forced_audio(ap_q):
        if not ap_q:
            return None
        codes = ap_q.pop(0)
        fa = torch.full((1, lm_cfg.runtime_dep_q), UNGENERATED,
                        dtype=torch.int64)
        fa[0, : len(codes)] = torch.tensor(codes, dtype=torch.int64)
        return fa.to(dev)

    def _forced_text(tp):
        return (torch.tensor([tp.pop(0)], dtype=torch.int64, device=dev)
                if tp else None)

    def host_loop(ms, done):
        """Frames with the host FSM: the sampled text token goes through
        ``ms`` every frame (two phases and one D->H fetch, the reference's
        moshi-tts.cpp / lm.h); ``done(offset)`` ends the loop."""
        state = new_state()
        tp = list(text_prefixes)
        ap_q = list(audio_prefixes)
        wav_parts = []
        t0 = None
        frames = offset = 0
        while frames < args.max_frames:
            replace = offset < lm_cfg.delay_steps
            forced_text = int(tp.pop(0)) if tp else None
            out, state = pipe.step(mimi_params, lm_params, state,
                                   machine=machine, machine_state=ms,
                                   offset=offset, forced_text=forced_text,
                                   forced_audio=_forced_audio(ap_q),
                                   condition_sum=condition_sum,
                                   cross_kv=cross_kv,
                                   depformer_replace=replace)
            offset += 1
            frames += 1
            if bool(out["valid"][0]) and not replace:
                wav_parts.append(out["audio_out"][0].cpu().numpy())
            if frames == 1:
                # frame 0 (kernel builds) is left out of the time
                t0 = time.perf_counter()
            if done(offset):
                break
        dt = time.perf_counter() - t0 if t0 else 1.0
        return wav_parts, frames, max(frames - 1, 1) / dt

    def generate_host():
        """The reference's loop structure: the host FSM every frame."""
        ms = machine.new_state(entries)
        return host_loop(ms, lambda offset: (
            ms.end_step >= 0 and offset >= ms.end_step
            + lm_cfg.delay_steps + FINAL_PADDING))

    def generate_device():
        """The FSM on the device (``models/device_machine.py``): one frame
        a step with no host round trip; the host reads the end marker
        every ``--window`` frames (every frame by default), a 4-byte
        fetch."""
        from moshi_tpu_torch.models.device_machine import (compile_script,
                                                           init_device_state)
        dm = pipe.enable_device_fsm(machine)
        script_arr = compile_script([entries], dm, device=dev)
        state = new_state()
        mdev = init_device_state(dm, script_arr)
        tp = list(text_prefixes)
        ap_q = list(audio_prefixes)
        outs = []
        t0 = None
        f = 0
        end = -1
        win = max(1, args.window)
        while f < args.max_frames:
            replace = f < lm_cfg.delay_steps
            out, state, mdev = pipe.step_device(
                mimi_params, lm_params, state, mdev, script_arr,
                forced_text=_forced_text(tp),
                forced_audio=_forced_audio(ap_q),
                condition_sum=condition_sum, cross_kv=cross_kv,
                depformer_replace=replace)
            outs.append(out)
            if f == 0 or (f + 1) % win == 0:
                end = int(out["end_step"][0])          # D->H consume
            f += 1
            if f == 1:
                t0 = time.perf_counter()   # frame 0 (kernel builds) out
            if end >= 0 and f >= min(args.max_frames, end
                                     + lm_cfg.delay_steps + FINAL_PADDING):
                break
        end = int(outs[-1]["end_step"][0])
        frames = (min(f, end + lm_cfg.delay_steps + FINAL_PADDING)
                  if end >= 0 else f)
        outs = outs[:frames]
        dt = time.perf_counter() - t0 if t0 else 1.0
        wav_parts = [o["audio_out"][0].cpu().numpy()
                     for i, o in enumerate(outs)
                     if i >= lm_cfg.delay_steps and bool(o["valid"][0])]
        return wav_parts, frames, max(frames - 1, 1) / dt

    def generate_interactive():
        """The reference's moshi-tts.cpp interactive mode: a reader thread
        tokenizes stdin lines into entries and appends them to the LIVE
        machine state while the frame loop runs (the host FSM: the word
        queue must be host-mutable).  New words clear end_step, reviving
        a stream that ran dry; generation stops after EOF once the
        machine drains, plus the final padding."""
        import threading
        ms = machine.new_state([])
        eof = threading.Event()

        def reader():
            for line in sys.stdin:
                line = line.strip()
                if not line:
                    continue
                for e in script_to_entries(tok, ids, 12.5, [line],
                                           multi_speaker=False,
                                           padding_between=1):
                    ms.entries.append(e)
                ms.end_step = -1          # new words revive the stream
            eof.set()

        threading.Thread(target=reader, daemon=True).start()
        return host_loop(ms, lambda offset: (
            eof.is_set() and ms.end_step >= 0 and ms.is_empty()
            and offset >= ms.end_step + lm_cfg.delay_steps + FINAL_PADDING))

    def generate_scan():
        """Offline: the device FSM, ``scan_device`` ``SCAN_CHUNK`` frames
        a call, the host reading the end marker once a chunk.  The
        depformer-replace lead-in and any voice prefix run frame by frame
        first."""
        from moshi_tpu_torch.models.device_machine import (compile_script,
                                                           init_device_state)
        dm = pipe.enable_device_fsm(machine)
        script_arr = compile_script([entries], dm, device=dev)

        # a scanned frame and a depformer-replace frame once on a
        # throwaway state: kernel builds are left out of the time, like
        # frame 0 in the frame loops
        wstate = new_state()
        wm = init_device_state(dm, script_arr)
        _, _, e, wstate, wm = pipe.scan_device(
            mimi_params, lm_params, wstate, wm, script_arr, 1,
            condition_sum, cross_kv)
        out0, wstate, wm = pipe.step_device(
            mimi_params, lm_params, wstate, wm, script_arr,
            condition_sum=condition_sum, cross_kv=cross_kv,
            depformer_replace=True)
        out0["end_step"].cpu()
        del wstate, wm, out0, e

        state = new_state()
        mdev = init_device_state(dm, script_arr)
        tp = list(text_prefixes)
        ap_q = list(audio_prefixes)
        t0 = time.perf_counter()
        head = 0
        f = 0
        # per-frame lead-in: depformer-replace window + forced prefixes
        while f < lm_cfg.delay_steps or tp or ap_q:
            _, state, mdev = pipe.step_device(
                mimi_params, lm_params, state, mdev, script_arr,
                forced_text=_forced_text(tp),
                forced_audio=_forced_audio(ap_q),
                condition_sum=condition_sum, cross_kv=cross_kv,
                depformer_replace=f < lm_cfg.delay_steps)
            head += 1
            f += 1
        chunks = []

        def scan(c):
            nonlocal state, mdev
            audio_c, valid_c, end_c, state, mdev = pipe.scan_device(
                mimi_params, lm_params, state, mdev, script_arr, c,
                condition_sum, cross_kv)
            chunks.append((audio_c, valid_c, end_c))
            return int(end_c[-1][0])                   # 1 fetch a chunk

        end = -1
        while end < 0 and f < args.max_frames:
            c = min(SCAN_CHUNK, args.max_frames - f)
            end = scan(c)
            f += c
        if end >= 0:
            # the delay/padding window AFTER the end token still carries
            # audio (the frame loops generate through it); top up to it
            # when the end landed near the last chunk's tail
            tail_total = min(args.max_frames,
                             end + lm_cfg.delay_steps + FINAL_PADDING)
            while f < tail_total:
                c = min(SCAN_CHUNK, tail_total - f)
                scan(c)
                f += c
        if not chunks:          # --max-frames within the lead-in
            return [], f, max(f - 1, 1) / (time.perf_counter() - t0)
        audio = torch.cat([a for a, _, _ in chunks]).cpu().numpy()
        valid = torch.cat([v for _, v, _ in chunks]).cpu().numpy()
        ends = torch.cat([e for _, _, e in chunks]).cpu().numpy()
        dt = time.perf_counter() - t0
        # assemble: the lead-in frames (invalid or replaced), then the
        # chunks' frames up to the end marker + delay + final padding
        end_first = next((i for i in range(len(ends))
                          if ends[i][0] >= 0), len(ends))
        end_step = int(ends[end_first][0]) if end_first < len(ends) \
            else -1
        total = (min(args.max_frames, end_step + lm_cfg.delay_steps +
                     FINAL_PADDING) if end_step >= 0 else f)
        # the end can land near the tail of the last chunk, with total
        # past the frames generated: clamp to what exists
        keep = min(max(0, total - head), len(audio))
        wav_parts = [audio[i][0] for i in range(keep) if valid[i][0]]
        frames = min(f, total)
        return wav_parts, frames, max(frames - 1, 1) / dt

    generate = (generate_interactive if args.interactive
                else generate_scan if args.scan
                else generate_host if args.host_fsm else generate_device)
    if args.bench:
        generate()          # kernel builds and both depformer forms first
    t0 = time.perf_counter()
    wav_parts, frames, fps = generate()
    dt = time.perf_counter() - t0
    text_tokens = frames
    wav = np.concatenate(wav_parts) if wav_parts else np.zeros(FRAME_SIZE)
    from moshi_tpu_torch.io.media import save_audio as save_wav
    save_wav(args.output, wav, SAMPLE_RATE)
    print(f"wrote {args.output}: {len(wav) / SAMPLE_RATE:.2f}s audio, "
          f"{frames} frames in {dt:.2f}s")
    print(f"bench: {fps:.2f} frames/s ({fps / 12.5:.2f}x realtime), "
          f"{text_tokens / dt:.1f} tokens/s, seed {args.seed}")
    if args.bench:
        print(json.dumps({"metric": "tts_frames_per_sec", "value":
                          round(fps, 2), "unit": "frames/s"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
