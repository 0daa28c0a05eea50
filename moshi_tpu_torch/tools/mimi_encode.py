"""mimi-encode: audio file -> .mimi RVQ token file.

Counterpart of ``moshi_tpu/tools/mimi_encode.py`` and the reference's
tools/mimi-encode.cpp: media -> 24 kHz mono -> streaming Mimi encode
(``MimiStreamer``, ``--chunk-frames`` frames a call) -> the MIMI magic,
n_q and int16 frames.  The output's bytes follow the reference's format,
so .mimi files interchange between the stacks.

Usage: python -m moshi_tpu_torch.tools.mimi_encode -i in.wav -o out.mimi
       [-n N_Q] [-m mimi.safetensors] [--synthetic] [--torch-device cpu]
"""

import argparse

import numpy as np

from moshi_tpu_torch import FRAME_SIZE
from moshi_tpu_torch.io.mimi_file import write_mimi_file
from moshi_tpu_torch.runtime.session import MimiStreamer
from moshi_tpu_torch.tools.common import (add_common_args, list_devices,
                                          load_mimi, read_audio_24k,
                                          torch_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=False)
    ap.add_argument("-o", "--output", default="out.mimi")
    ap.add_argument("-n", "--n-q", type=int, default=32)
    ap.add_argument("-m", "--mimi-file",
                    default="tokenizer-e351c8d8-checkpoint125.safetensors")
    ap.add_argument("--chunk-frames", type=int, default=25,
                    help="frames per encode call (2s default)")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.list_devices:
        list_devices()
        return 0
    dev = torch_device(args)
    model, params = load_mimi(args, n_q=args.n_q)
    streamer = MimiStreamer(model, params, device=dev)
    audio = read_audio_24k(args.input)
    frame = FRAME_SIZE * args.chunk_frames
    n = (len(audio) + FRAME_SIZE - 1) // FRAME_SIZE
    audio = np.pad(audio, (0, n * FRAME_SIZE - len(audio)))
    out = []
    for i in range(0, len(audio), frame):
        chunk = audio[i:i + frame]
        codes = streamer.encode(chunk[None])
        out.append(codes[0])
    codes = np.concatenate(out, axis=0)
    write_mimi_file(args.output, codes)
    print(f"wrote {args.output}: {codes.shape[0]} frames x {codes.shape[1]} "
          f"codebooks ({codes.shape[0] / 12.5:.2f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
