"""Shared command-line plumbing: model path resolution, config and weights
loading, the card the tools run on.

Counterpart of ``moshi_tpu/tools/common.py``, with the reference's model
search (tools/common_utils.h: the MODEL_CACHE variable, an explicit
directory, then the working directory) and device listing.  Every tool
runs on the CUDA card unless ``--torch-device cpu`` is given, where each
kernel wrapper runs its plain PyTorch version; without a card the default
raises (``device.resolve_device``).  Audio comes from files
(``io/media.py``) or, with ``--device``, from a live audio backend
(``io/audio_device.py``).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from moshi_tpu_torch.device import resolve_device


def model_cache_dir() -> Path:
    env = os.environ.get("MODEL_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "moshi"


def resolve_model_file(name: str, model_dir: Optional[str] = None) -> Path:
    """The reference's search order: explicit dir, cwd, MODEL_CACHE."""
    cands = []
    if model_dir:
        cands.append(Path(model_dir) / name)
    cands.append(Path(name))
    cands.append(model_cache_dir() / name)
    for c in cands:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"model file {name!r} not found (searched: "
        + ", ".join(str(c) for c in cands) + ")")


def list_devices():
    """The CUDA cards: index, name, memory."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        print("no CUDA device (--torch-device cpu runs the plain versions)")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"{i}: {p.name} ({p.total_memory / 2 ** 30:.1f} GiB)")


def add_common_args(ap: argparse.ArgumentParser):
    ap.add_argument("-d", "--model-dir", default=None,
                    help="directory containing model files")
    ap.add_argument("-l", "--list-devices", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true",
                    help="random weights (no checkpoint needed; for "
                         "smoke tests and benches)")
    ap.add_argument("-q", "--quantize", default=None,
                    choices=["q4_0", "q4_k", "q8_0", "q8_r"],
                    help="weight-only quantization at load")
    ap.add_argument("-g", "--use-cache", action="store_true",
                    help="cache the quantized model to disk and reload "
                         "from it (the reference's GGUF-cache flow)")
    ap.add_argument("--window", type=int, default=1,
                    help="fetch results to the host every N frames (1 = "
                         "reference-style per-frame consumption)")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device the model runs on (default "
                         "cuda; cpu runs each kernel's plain PyTorch "
                         "version)")


def torch_device(args) -> torch.device:
    """The device the tool runs on: ``--torch-device``, checked."""
    return resolve_device(getattr(args, "torch_device", "cuda"))


def load_mimi(args, n_q: int = 32):
    """Build MimiModel (+params from checkpoint or random, bf16)."""
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.runtime.loader import load_mimi_params
    from moshi_tpu_torch.runtime.synth import synth_mimi_params
    dev = torch_device(args)
    cfg = MimiConfig(n_q=n_q)
    model = MimiModel(cfg)
    if args.synthetic:
        params = synth_mimi_params(cfg, device=dev, seed=args.seed)
    else:
        path = resolve_model_file(args.mimi_file, args.model_dir)
        params = load_mimi_params(str(path), model, device=dev)
    return model, params


def load_lm(args, config):
    """Build LMConfig + params from a MoshiConfig."""
    from moshi_tpu_torch.models.lm import LMConfig
    from moshi_tpu_torch.runtime.loader import load_lm_params
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    dev = torch_device(args)
    audio_delay = 0.0
    if config.model_type == "tts" or getattr(args, "tts", False):
        audio_delay = config.tts_config.audio_delay
    elif config.model_type == "stt" or getattr(args, "stt", False):
        audio_delay = config.stt_config.audio_delay_seconds
    cfg = LMConfig.from_moshi_config(config, audio_delay=audio_delay)
    if args.synthetic:
        return cfg, synth_lm_params(cfg, args.quantize, device=dev,
                                    seed=args.seed)
    path = resolve_model_file(config.moshi_name, args.model_dir)
    if getattr(args, "use_cache", False) and args.quantize:
        from moshi_tpu_torch.runtime.cache import (load_quantized,
                                                   save_quantized)
        cache_path = Path(str(path) + f".{args.quantize}.moshi-tpu")
        if cache_path.exists():
            print(f"loading quantized cache {cache_path}")
            return cfg, load_quantized(str(cache_path), device=dev)
        params = load_lm_params(str(path), cfg, fmt=args.quantize,
                                device=dev)
        print(f"writing quantized cache {cache_path}")
        save_quantized(str(cache_path), params,
                       metadata={"fmt": args.quantize})
        return cfg, params
    return cfg, load_lm_params(str(path), cfg, fmt=args.quantize, device=dev)


def load_tokenizer(args, config):
    from moshi_tpu_torch.tokenizer import SentencePieceTokenizer
    if args.synthetic:
        return None
    path = resolve_model_file(config.tokenizer_name, args.model_dir)
    return SentencePieceTokenizer.from_file(str(path))


def load_config_arg(args, default: dict):
    """The MoshiConfig of ``-c``, or ``default``'s without one."""
    import json

    from moshi_tpu_torch.config import parse_config
    if args.config:
        with open(args.config) as fh:
            return parse_config(json.load(fh))
    return parse_config(default)


def read_audio_24k(path: str) -> np.ndarray:
    """Decode any supported media file (WAV/AIFF/AU natively; mp3/ogg/
    containers through an ffmpeg binary when present) to 24 kHz mono
    float32: the reference's common_av.h Decoder and Resampler."""
    from moshi_tpu_torch.io.media import load_audio
    x, _ = load_audio(path, rate=24_000)
    return x
