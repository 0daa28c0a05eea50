"""mimi-decode: .mimi token file -> audio file.

Counterpart of ``moshi_tpu/tools/mimi_decode.py`` and the reference's
tools/mimi-decode.cpp: streaming Mimi decode (``MimiStreamer``,
``--chunk-frames`` frames a call), WAV natively, other containers through
ffmpeg.

Usage: python -m moshi_tpu_torch.tools.mimi_decode -i in.mimi -o out.wav
"""

import argparse

import numpy as np

from moshi_tpu_torch import SAMPLE_RATE
from moshi_tpu_torch.io.media import save_audio as save_wav
from moshi_tpu_torch.io.mimi_file import read_mimi_file
from moshi_tpu_torch.runtime.session import MimiStreamer
from moshi_tpu_torch.tools.common import (add_common_args, list_devices,
                                          load_mimi, torch_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=False)
    ap.add_argument("-o", "--output", default="out.wav")
    ap.add_argument("-m", "--mimi-file",
                    default="tokenizer-e351c8d8-checkpoint125.safetensors")
    ap.add_argument("--chunk-frames", type=int, default=25)
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.list_devices:
        list_devices()
        return 0
    dev = torch_device(args)
    codes = read_mimi_file(args.input)
    model, params = load_mimi(args, n_q=codes.shape[1])
    streamer = MimiStreamer(model, params, device=dev)
    out = []
    for i in range(0, codes.shape[0], args.chunk_frames):
        chunk = codes[i:i + args.chunk_frames].astype(np.int32)
        audio = streamer.decode(chunk[None])
        out.append(audio[0])
    wav = np.concatenate(out)
    save_wav(args.output, wav, SAMPLE_RATE)
    print(f"wrote {args.output}: {len(wav) / SAMPLE_RATE:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
