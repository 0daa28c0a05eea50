"""personaplex: voice-cloned full-duplex dialog.

Counterpart of ``moshi_tpu/tools/personaplex.py`` and the reference's
tools/personaplex.cpp: moshi-sts for PersonaPlex.  The voice comes from a
precomputed .safetensors (voice.embeddings + voice.cache) or from a wav
(its Mimi codes replayed), ``-p`` is the system prompt, the session is
primed with both before it starts (``models/personaplex.py``
``prime_system_prompts``), and the depformer runs 8 of its 16 steps.

Usage: python -m moshi_tpu_torch.tools.personaplex -c config.json
       --voice NATF0.safetensors -p "You are a helpful assistant" -i in.wav
"""

import argparse

import numpy as np
import torch

from moshi_tpu_torch import FRAME_SIZE, SAMPLE_RATE
from moshi_tpu_torch.tools.common import (add_common_args, list_devices,
                                          load_config_arg, load_lm,
                                          load_mimi, load_tokenizer,
                                          read_audio_24k, torch_device)

DEFAULT_CONFIG = {"model_type": "personaplex", "dim": 64, "num_layers": 2,
                  "num_heads": 8, "context": 64, "n_q": 16, "dep_q": 16,
                  "card": 2048, "text_card": 4000,
                  "delays": [0, 0] + [1] * 7 + [0] + [1] * 7,
                  "depformer_dim": 32, "depformer_num_layers": 2,
                  "hidden_scale": 4.0,
                  "depformer_weights_per_step_schedule": list(range(8))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", default=None)
    ap.add_argument("-o", "--output", default="personaplex.wav")
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--voice", default=None,
                    help="voice file (.safetensors with voice.embeddings/"
                         "voice.cache, or a wav to mimi-encode)")
    ap.add_argument("-p", "--prompt", default=None, help="system prompt")
    ap.add_argument("--frames", type=int, default=125)
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.list_devices:
        list_devices()
        return 0

    dev = torch_device(args)
    config = load_config_arg(args, DEFAULT_CONFIG)
    args.mimi_file = config.mimi_name     # the codec checkpoint
    config.model_type = "personaplex"
    lm_cfg, lm_params = load_lm(args, config)
    if not (lm_cfg.personaplex and lm_cfg.runtime_dep_q == 8):
        raise ValueError("personaplex runs a PersonaPlex config: 8 of its "
                         f"depformer steps, not {lm_cfg.runtime_dep_q}")
    mimi, mimi_params = load_mimi(args, n_q=lm_cfg.n_q)
    tok = load_tokenizer(args, config)

    from moshi_tpu_torch.models.personaplex import (load_voice_file,
                                                    prime_system_prompts)
    from moshi_tpu_torch.runtime.pipeline import STSPipeline
    from moshi_tpu_torch.runtime.session import MimiStreamer

    pipe = STSPipeline(mimi, lm_cfg,
                       temp=config.lm_gen_config.temp,
                       temp_text=config.lm_gen_config.temp_text,
                       top_k=config.lm_gen_config.top_k,
                       top_k_text=config.lm_gen_config.top_k_text,
                       mimi_dtype=torch.float32 if args.synthetic
                       else torch.bfloat16, device=dev)
    state = pipe.init_state(1, seed=args.seed, lm_params=lm_params)
    # -- priming --------------------------------------------------------
    voice_emb = voice_cache = None
    voice_codes = None
    if args.voice:
        if args.voice.endswith(".safetensors"):
            voice_emb, voice_cache, _ = load_voice_file(args.voice, lm_cfg)
        else:
            audio = read_audio_24k(args.voice)
            n = len(audio) // FRAME_SIZE
            st = MimiStreamer(mimi, mimi_params, device=dev)
            codes = st.encode(audio[: n * FRAME_SIZE][None])[0]
            voice_codes = [list(map(int, c[:8])) for c in codes]
    text_prompt = []
    if args.prompt:
        wrapped = f"<system> {args.prompt} <system>"
        text_prompt = tok.encode(wrapped) if tok else [3] * 4
    state["lm"] = prime_system_prompts(
        lm_cfg, lm_params, state["lm"], text_prompt,
        voice_embeddings=voice_emb, voice_cache=voice_cache,
        voice_audio_codes=voice_codes)
    primed_frames = int(state["lm"]["offset"][0])
    print(f"primed {primed_frames} frames")

    # -- session --------------------------------------------------------
    if args.input:
        audio = read_audio_24k(args.input)
        n = len(audio) // FRAME_SIZE
        audio = audio[: n * FRAME_SIZE]
    else:
        n = args.frames
        audio = np.zeros(n * FRAME_SIZE, np.float32)
    out_parts = []
    transcript = []
    for f in range(n):
        frame = audio[f * FRAME_SIZE:(f + 1) * FRAME_SIZE][None]
        out, state = pipe.step(mimi_params, lm_params, state, frame)
        out_parts.append(out["audio_out"][0].cpu().numpy())
        t = int(out["text"][0])
        if tok and t >= 0 and t not in (0, 3):
            transcript.append(tok.id_to_piece(t))
    from moshi_tpu_torch.io.media import save_audio as save_wav
    save_wav(args.output, np.concatenate(out_parts), SAMPLE_RATE)
    if transcript:
        print("".join(transcript).replace("▁", " ").strip())
    print(f"wrote {args.output}: {n} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
