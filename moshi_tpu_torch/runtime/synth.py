"""Synthetic LM and Mimi weights made directly on the device.

Counterpart of ``moshi_tpu/runtime/synth.py``: the same parameter tree as
the JAX package's ``init_lm_params``, with every 2-D matmul/embedding
weight quantized per the policy (``quant/policy.py``) as random packed
bits and fixed scales, and every other leaf N(0, 0.02) in bf16.  Random
bits cost the kernels exactly what real weights cost, so the 7B runs
without checkpoints.  ``synth_mimi_params`` draws Mimi's tree through
``MimiModel.init_params`` (the JAX package's distributions) from a seed.
``synth_conditioners`` draws the voice conditioners of the
cross-attention TTS models (the tree ``models/tts.py``'s
``load_conditioners`` reads from a checkpoint), and ``tts_class_config``
is the TTS class of ``configs/bench/tts-default-class.json`` with
cross-attention on.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.models.lm import LMConfig
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.quant.formats import QK, QK_K, QuantTensor
from moshi_tpu_torch.quant.policy import choose_format


# the TTS class: the reference's hard defaults for the tts-1.6b-en_fr family
TTS_CLASS = (Path(__file__).resolve().parents[2] / "configs" / "bench"
             / "tts-default-class.json")


def tts_class_config(num_layers: int = 0):
    """(MoshiConfig, LMConfig) of the TTS class (``TTS_CLASS``, read with
    ``config.load_config``) with cross-attention on, the audio delay
    from its tts_config, and ``num_layers`` temporal layers if given."""
    from moshi_tpu_torch.config import load_config
    mc = load_config(str(TTS_CLASS))
    mc.cross_attention = True
    cfg = LMConfig.from_moshi_config(mc,
                                     audio_delay=mc.tts_config.audio_delay)
    return mc, dataclasses.replace(cfg,
                                   num_layers=num_layers or cfg.num_layers)


def lm_param_shapes(cfg: LMConfig):
    """The parameter tree's leaf shapes (the JAX package's
    init_lm_params): with ``demux_second_stream`` each text embedding has
    its dim x dim ``out1`` and ``out2``."""
    d, nl, hid = cfg.dim, cfg.num_layers, cfg.hidden_dim

    def text_emb(width):
        tree = {"weight": (cfg.text_card + 1, width)}
        if cfg.demux_second_stream:
            tree["out1"] = {"weight": (width, width)}
            tree["out2"] = {"weight": (width, width)}
        return tree

    layers = {
        "norm1": {"alpha": (nl, d)},
        "self_attn": {"in_proj": {"weight": (nl, 3 * d, d)},
                      "out_proj": {"weight": (nl, d, d)}},
        "norm2": {"alpha": (nl, d)},
        "gating": {"linear_in": {"weight": (nl, 2 * hid, d)},
                   "linear_out": {"weight": (nl, d, hid)}},
    }
    if cfg.cross_attention:
        layers["norm_cross"] = {"weight": (nl, d), "bias": (nl, d)}
        layers["cross_attention"] = {
            "in_proj": {"weight": (nl, 3 * d, d)},
            "out_proj": {"weight": (nl, d, d)}}
    tree = {
        "text_emb": text_emb(d),
        "emb": {"weight": (cfg.n_q, cfg.card + 1, d)},
        "transformer": {"layers": layers},
        "out_norm": {"alpha": (d,)},
        "text_linear": {"weight": (cfg.text_card, d)},
    }
    if cfg.extra_heads_num:
        tree["extra_heads"] = {
            "weight": (cfg.extra_heads_num, cfg.extra_heads_dim, d)}
    if cfg.dep_q > 0:
        dd, dl, dhid = cfg.depformer_dim, cfg.depformer_layers, \
            cfg.depformer_hidden
        w = cfg.depformer_num_weights
        dep = {
            "in": {"weight": (w, dd, d)},
            "text_emb": text_emb(dd),
            "layers": {
                "norm1": {"alpha": (dl, dd)},
                "norm2": {"alpha": (dl, dd)},
                "self_attn": {"in_proj": {"weight": (w, dl, 3 * dd, dd)},
                              "out_proj": {"weight": (w, dl, dd, dd)}},
                "gating": {"linear_in": {"weight": (w, dl, 2 * dhid, dd)},
                           "linear_out": {"weight": (w, dl, dd, dhid)}},
            },
            "linears": {"weight": (cfg.dep_q, cfg.card, dd)},
        }
        if cfg.dep_q > 1:
            lr = cfg.depformer_low_rank
            dep["emb"] = {"weight": (cfg.dep_q - 1, cfg.card + 1, lr),
                          "low_rank": {"weight": (cfg.dep_q - 1, dd, lr)}}
        tree["depformer"] = dep
    return tree


def synth_quant_tensor(fmt: str, lead, out_dim: int, in_dim: int, gen,
                       device, scale: float = 0.02) -> QuantTensor:
    """Random packed QuantTensor [*lead, out_dim, in_dim] on ``device``."""
    lead = tuple(lead)

    def bits(shape, high=256):
        return torch.randint(0, high, lead + shape, generator=gen,
                             dtype=torch.uint8, device=device)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.bfloat16,
                          device=device)

    if fmt == "q8_0":
        q = torch.randint(-127, 128, lead + (out_dim, in_dim), generator=gen,
                          dtype=torch.int8, device=device)
        return QuantTensor(fmt, (out_dim, in_dim), q,
                           full((out_dim, in_dim // QK), scale / 127))
    if fmt == "q4_0":
        return QuantTensor(fmt, (out_dim, in_dim), bits((out_dim, in_dim // 2)),
                           full((out_dim, in_dim // QK), scale / 8))
    if fmt == "q4_k":
        # w = es*q - em with es = d*sc and em = dmin*mn.  The mins are drawn
        # so that each block is zero-mean, as a real block's min sits near
        # minus its max (em ~ 7.5 es, i.e. mn ~ sc/2, rounded up or down at
        # random): with independent mins every row shares a mean of about
        # -scale/4, the outputs follow the activation's sum, and the tokens
        # stop depending on the input.
        nsb = in_dim // QK_K
        sc = bits((out_dim, nsb, 8), 64)
        mn = (sc + bits((out_dim, nsb, 8), 2)) // 2
        return QuantTensor(
            fmt, (out_dim, in_dim), bits((out_dim, in_dim // 2)),
            full((out_dim, nsb), scale / (63 * 15)), sc=sc, mn=mn,
            dmin=full((out_dim, nsb), scale / 63)).with_eff_scales()
    raise ValueError(f"unsupported quant format {fmt!r}")


def synth_lm_params(cfg: LMConfig, fmt: str | None = "q4_k", device="cuda",
                    seed: int = 0):
    """Random LM params on ``device`` from ``seed``; 2-D matmul weights
    follow the quantization policy when ``fmt`` is given."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(name, shape):
        actual = (choose_format(name, shape[-2:], fmt)
                  if fmt and len(shape) >= 2 else None)
        if actual is not None:
            return synth_quant_tensor(actual, shape[:-2], shape[-2],
                                      shape[-1], gen, dev)
        return (torch.randn(shape, generator=gen, device=dev) * 0.02
                ).to(torch.bfloat16)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in tree.items()}
        return make(path, tree)

    return walk(lm_param_shapes(cfg), "")


def synth_conditioners(dim: int, cond_dim: int = 128, wav_dim: int = 512,
                       device="cuda", seed: int = 0):
    """Random voice conditioners on ``device`` from ``seed``, f32 as
    ``load_conditioners`` returns them: the cfg table (7 rows, cfg 1.0 to
    4.0) and the control table (1 row, "ok") of width ``cond_dim``, each
    with its output projection to ``dim``, and the speaker-embedding
    projection from ``wav_dim``; every learnt padding [1, dim].  The
    widths are synthetic: the checkpoint's are not in the repository."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def lut(rows):
        return {"embed": normal(rows, cond_dim),
                "learnt_padding": normal(1, dim),
                "output_proj": {"weight": normal(dim, cond_dim,
                                                 scale=cond_dim ** -0.5)}}

    return {"cfg": lut(7), "control": lut(1),
            "speaker_wavs": {"learnt_padding": normal(1, dim),
                             "output_proj": {"weight": normal(
                                 dim, wav_dim, scale=wav_dim ** -0.5)}}}


def tree_nbytes(tree) -> int:
    """Bytes held by a parameter tree (packed components for quantized
    leaves)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, QuantTensor):
        return tree.nbytes
    return tree.numel() * tree.element_size()


def synth_mimi_params(cfg: MimiConfig, device="cuda", seed: int = 0,
                      dtype=torch.bfloat16):
    """Random Mimi params on ``device`` from ``seed``, in ``dtype``.  The
    JAX package's init scales need no change: the full-width Mimi's
    decoded audio stays finite in bf16 (its largest magnitude is about
    0.4 for input audio of N(0, 0.1) and random codes; ``chip_smoke.py``
    checks it on the card every run), although ``bench.py`` notes that
    random SEANet weights can overflow bf16."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return MimiModel(cfg).init_params(gen, dtype, dev)
