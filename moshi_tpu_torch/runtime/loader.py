"""Checkpoints into the port's parameter trees, and parameter trees into
GGUF files.

Counterpart of ``moshi_tpu/runtime/loader.py``: the same checkpoint
names, the same trees (the JAX package's layouts, which
``runtime/convert.py`` documents), the same quantization on load, so that
``load_lm_params`` / ``load_mimi_params`` give, leaf for leaf and bit for
bit, the tree ``params_from_numpy`` makes of the JAX loader's.

* Mimi names (``load_mimi_params``): "mimi.encoder.model.N.conv.conv.
  weight", "mimi.upsample.convtr.convtr.convtr.weight", "mimi.
  encoder_transformer.transformer.layers.I. ...", "mimi.quantizer.
  rvq_first.vq.layers.J._codebook.embedding_sum", ...; each codebook is
  ``embedding_sum / clamp(cluster_usage, 1e-5)`` in numpy f32 (or the
  stored "embedding"), transposed-conv weights go from torch's [I, O/g, K]
  to [O, I/g, K].
* LM names under "lm." (``load_lm_params``): fused "self_attn.
  in_proj_weight", gating linears, rms "alpha"s, the depformer's per-step
  "in_projs.J.weight" / "gating.J.*", "depformer_in.J.weight", low-rank
  depformer embeddings, "linears.J.weight", "extra_heads.J.weight", and
  with ``demux_second_stream`` the text embeddings' "out1" / "out2".  The
  depformer's per-step weights are stacked steps-outer, [W, L, ...].
* A ".gguf" path is read through ``io/gguf.py`` (the CRC names, and the
  split attention names "in_projs.0" / "out_projs.0" the GGUF files keep):
  its quantized tensors keep the file's format (q4_k with its es/em).
  From safetensors, ``fmt`` (q8_0, q4_0, q4_k, q8_r) quantizes each
  weight the policy picks (``quant/policy.py``) with the native quantizer
  (``native_quant.py``; q8_r by numpy).  Other weights are cast from f32
  to ``dtype``; norms, biases, layer scales and codebooks stay f32.

Weights go to ``device`` one leaf at a time (each layer's, then the
stack), so the host never holds the whole tree.  ``save_lm_gguf`` /
``save_mimi_gguf`` write a tree in the reference's GGUF names; the
repacks run on the tree's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.io.safetensors import SafeTensors
from moshi_tpu_torch.models.lm import LMConfig
from moshi_tpu_torch.models.mimi import MimiModel
from moshi_tpu_torch.nn.conv import (StreamingConvTranspose1d,
                                     oiw_to_torch_convtr,
                                     torch_convtr_weight_to_oiw)
from moshi_tpu_torch.quant.formats import QuantTensor, quantize
from moshi_tpu_torch.quant.policy import choose_format

# the fused attention names of the safetensors checkpoints and the split
# names the reference keeps in GGUF (one split for the temporal and Mimi
# attention)
_GGUF_ALIASES = (
    (".in_proj_weight", ".in_projs.0.weight"),
    (".in_proj_bias", ".in_projs.0.bias"),
    (".out_proj.weight", ".out_projs.0.weight"),
    (".out_proj.bias", ".out_projs.0.bias"),
)


class _GGUFAdapter:
    """A SafeTensors-like view over a GGUF file: the CRC renaming and the
    fused -> split attention aliases resolved; quantized tensors come back
    as QuantTensors on ``device`` (repacked there)."""

    def __init__(self, path: str, device):
        from moshi_tpu_torch.io.gguf import GGUFReader
        self.reader = GGUFReader(path)
        self.device = device

    def _stored(self, name: str):
        from moshi_tpu_torch.io.gguf import gguf_tensor_name
        cands = [name]
        for suffix, alias in _GGUF_ALIASES:
            if name.endswith(suffix):
                cands.append(name[: -len(suffix)] + alias)
        for cand in cands:
            s = gguf_tensor_name(cand)
            if s in self.reader:
                return s
        return None

    def __contains__(self, name: str) -> bool:
        return self._stored(name) is not None

    def __getitem__(self, name: str):
        s = self._stored(name)
        if s is None:
            raise KeyError(name)
        if self.reader.is_quantized(s):
            return self.reader.get_quant(s, self.device)
        return self.reader.get(s)

    def close(self):
        self.reader.close()


class _Source:
    """One view over one or more safetensors / GGUF files."""

    def __init__(self, device, *paths: str):
        self.files = [
            _GGUFAdapter(p, device) if p.endswith(".gguf") else SafeTensors(p)
            for p in paths
        ]

    def find(self, name: str) -> bool:
        return any(name in f for f in self.files)

    def get(self, name: str):
        for f in self.files:
            if name in f:
                return f[name]
        raise KeyError(name)

    def get_opt(self, name: str):
        return self.get(name) if self.find(name) else None

    def close(self):
        for f in self.files:
            f.close()


def _f32(a) -> torch.Tensor:
    """A host array as an f32 tensor on the host (copied if read-only)."""
    a = np.asarray(a, np.float32)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, np.float32)
    return torch.from_numpy(a)


class _Loader:
    """The helpers of one load: the source, the device and the dtype of
    the cast leaves."""

    def __init__(self, src: _Source, dev, dtype):
        self.src, self.dev, self.dtype = src, dev, dtype

    def cast(self, a, dtype=None) -> torch.Tensor:
        """f32 on the host -> ``dtype`` (the load's) on the device."""
        return _f32(a).to(self.dev).to(dtype or self.dtype)

    def maybe_quant(self, name: str, w, fmt: Optional[str]):
        if isinstance(w, QuantTensor):
            # quantized in the file (GGUF): the file's format wins
            return w.with_eff_scales()
        actual = choose_format(name, w.shape, fmt) if fmt else None
        if actual:
            return quantize(np.asarray(w, np.float32), actual,
                            device=self.dev)
        return self.cast(w)

    def linear(self, name: str, fmt):
        p = {"weight": self.maybe_quant(name + ".weight",
                                        self.src.get(name + ".weight"), fmt)}
        b = self.src.get_opt(name + ".bias")
        if b is not None:
            p["bias"] = self.cast(b, torch.float32)
        return p

    def norm(self, prefix: str):
        """rms norm ("alpha") or layer norm ("weight" / "bias")."""
        if self.src.find(prefix + ".alpha"):
            a = self.src.get(prefix + ".alpha")
            return {"alpha": self.cast(a, torch.float32).reshape(-1)}
        p = {"weight": self.cast(self.src.get(prefix + ".weight"),
                                 torch.float32)}
        b = self.src.get_opt(prefix + ".bias")
        p["bias"] = (self.cast(b, torch.float32) if b is not None
                     else torch.zeros_like(p["weight"]))
        return p

    def conv(self, prefix: str, transpose: bool = False, groups: int = 1):
        key = "convtr.convtr" if transpose else "conv.conv"
        w = _f32(self.src.get(f"{prefix}.{key}.weight"))
        if transpose:
            w = torch_convtr_weight_to_oiw(w, groups)
        p = {"weight": self.cast(w)}
        b = self.src.get_opt(f"{prefix}.{key}.bias")
        if b is not None:
            p["bias"] = self.cast(b, torch.float32)
        return p

    def attention(self, prefix: str, fmt):
        """The fused in_proj_weight and out_proj."""
        w = self.src.get(prefix + ".in_proj_weight")
        p = {"in_proj": {"weight": self.maybe_quant(
                prefix + ".in_proj_weight", w, fmt)},
             "out_proj": self.linear(prefix + ".out_proj", fmt)}
        b = self.src.get_opt(prefix + ".in_proj_bias")
        if b is not None:
            p["in_proj"]["bias"] = self.cast(b, torch.float32)
        return p

    def text_emb(self, prefix: str, demux: bool, fmt):
        p = {"weight": self.maybe_quant(prefix + ".weight",
                                        self.src.get(prefix + ".weight"),
                                        fmt)}
        if demux:
            p["out1"] = self.linear(prefix + ".out1", fmt)
            p["out2"] = self.linear(prefix + ".out2", fmt)
        elif self.src.find(prefix + ".low_rank.weight"):
            p["low_rank"] = self.linear(prefix + ".low_rank", None)
        return p


def _stack(trees):
    """Stack a list of same-shaped trees leaf by leaf along a new axis 0
    (a QuantTensor's components; its ``shape`` stays (O, I))."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, QuantTensor):
        comps = {f: (None if getattr(first, f) is None else
                     torch.stack([getattr(t, f) for t in trees]))
                 for f in ("q", "d", "sc", "mn", "dmin", "es", "em")}
        return QuantTensor(first.fmt, first.shape, **comps)
    return torch.stack(trees)


def _swap01(tree):
    """[L, W, ...] -> [W, L, ...] on every leaf (contiguous)."""
    if isinstance(tree, dict):
        return {k: _swap01(v) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return tree._map(lambda a: a.transpose(0, 1).contiguous())
    return tree.transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# Mimi
# ---------------------------------------------------------------------------

def _codebook_embedding(src: _Source, prefix: str) -> np.ndarray:
    emb = src.get_opt(prefix + ".embedding")
    if emb is not None:
        return np.asarray(emb, np.float32)
    s = np.asarray(src.get(prefix + ".embedding_sum"), np.float32)
    u = np.asarray(src.get(prefix + ".cluster_usage"), np.float32)
    return s / np.clip(u, 1e-5, None)[:, None]


def _mimi_transformer_layers(ld: _Loader, prefix: str, n_layers: int):
    layers = []
    for i in range(n_layers):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            "norm1": ld.norm(lp + ".norm1"),
            "self_attn": ld.attention(lp + ".self_attn", None),
            "norm2": ld.norm(lp + ".norm2"),
            "linear1": ld.linear(lp + ".linear1", None),
            "linear2": ld.linear(lp + ".linear2", None),
            "layer_scale_1": {"scale": ld.cast(
                ld.src.get(lp + ".layer_scale_1.scale"), torch.float32)},
            "layer_scale_2": {"scale": ld.cast(
                ld.src.get(lp + ".layer_scale_2.scale"), torch.float32)},
        })
    return {"layers": _stack(layers)}


def _seanet_params(ld: _Loader, net, prefix: str):
    return {name: ld.conv(f"{prefix}.{name}",
                          transpose=isinstance(mod, StreamingConvTranspose1d),
                          groups=getattr(mod, "groups", 1))
            for name, mod in net.modules.items()}


def _proj_1x1(ld: _Loader, name: str):
    """A 1x1 conv projection stored [out, in, 1] -> a linear [out, in]."""
    w = np.asarray(ld.src.get(name + ".weight"), np.float32)
    if w.ndim == 3:
        w = w[:, :, 0]
    return {"weight": ld.cast(w)}


def _rvq_branch(ld: _Loader, prefix: str, n_q: int):
    embs = [_codebook_embedding(ld.src, f"{prefix}.vq.layers.{i}._codebook")
            for i in range(n_q)]
    return {
        "embeddings": _f32(np.stack(embs)).to(ld.dev),
        "input_proj": _proj_1x1(ld, prefix + ".input_proj"),
        "output_proj": _proj_1x1(ld, prefix + ".output_proj"),
    }


def load_mimi_params(path: str, model: MimiModel, dtype=torch.bfloat16,
                     device="cuda"):
    """A Mimi checkpoint (tokenizer-*.safetensors, or its GGUF) as the
    MimiModel's parameter tree on ``device``."""
    dev = resolve_device(device)
    src = _Source(dev, path)
    ld = _Loader(src, dev, dtype)
    cfg = model.cfg
    try:
        upsample = torch_convtr_weight_to_oiw(
            _f32(src.get("mimi.upsample.convtr.convtr.convtr.weight")),
            cfg.dim)
        params = {
            "encoder": _seanet_params(ld, model.encoder, "mimi.encoder"),
            "encoder_transformer": _mimi_transformer_layers(
                ld, "mimi.encoder_transformer.transformer",
                cfg.transformer_layers),
            "downsample": {"weight": ld.cast(
                src.get("mimi.downsample.conv.conv.conv.weight"))},
            "quantizer": {
                "rvq_first": _rvq_branch(ld, "mimi.quantizer.rvq_first", 1),
                "rvq_rest": _rvq_branch(ld, "mimi.quantizer.rvq_rest",
                                        cfg.total_codebooks - 1),
            },
            "upsample": {"weight": ld.cast(upsample)},
            "decoder_transformer": _mimi_transformer_layers(
                ld, "mimi.decoder_transformer.transformer",
                cfg.transformer_layers),
            "decoder": _seanet_params(ld, model.decoder, "mimi.decoder"),
        }
    finally:
        src.close()
    return params


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def _lm_transformer_layers(ld: _Loader, cfg: LMConfig, fmt):
    layers = []
    for i in range(cfg.num_layers):
        lp = f"lm.transformer.layers.{i}"
        layer = {
            "norm1": ld.norm(lp + ".norm1"),
            "self_attn": ld.attention(lp + ".self_attn", fmt),
            "norm2": ld.norm(lp + ".norm2"),
            "gating": {
                "linear_in": ld.linear(lp + ".gating.linear_in", fmt),
                "linear_out": ld.linear(lp + ".gating.linear_out", fmt),
            },
        }
        if cfg.cross_attention:
            layer["norm_cross"] = ld.norm(lp + ".norm_cross")
            layer["cross_attention"] = ld.attention(
                lp + ".cross_attention", fmt)
        layers.append(layer)
    return {"layers": _stack(layers)}


def _depformer_layers(ld: _Loader, cfg: LMConfig, fmt):
    layers = []
    for i in range(cfg.depformer_layers):
        lp = f"lm.depformer.layers.{i}"
        steps_attn, steps_gate = [], []
        for j in range(cfg.depformer_num_weights):
            steps_attn.append({
                "in_proj": {"weight": ld.maybe_quant(
                    f"{lp}.self_attn.in_projs.{j}.weight",
                    ld.src.get(f"{lp}.self_attn.in_projs.{j}.weight"), fmt)},
                "out_proj": {"weight": ld.maybe_quant(
                    f"{lp}.self_attn.out_projs.{j}.weight",
                    ld.src.get(f"{lp}.self_attn.out_projs.{j}.weight"),
                    fmt)},
            })
            steps_gate.append({
                "linear_in": ld.linear(f"{lp}.gating.{j}.linear_in", fmt),
                "linear_out": ld.linear(f"{lp}.gating.{j}.linear_out", fmt),
            })
        layers.append({
            "norm1": ld.norm(lp + ".norm1"),
            "norm2": ld.norm(lp + ".norm2"),
            "self_attn": _stack(steps_attn),
            "gating": _stack(steps_gate),
        })
    stacked = _stack(layers)
    # steps-outer [W, L, ...]
    for key in ("self_attn", "gating"):
        stacked[key] = _swap01(stacked[key])
    return stacked


def load_lm_params(path: str, cfg: LMConfig, fmt: Optional[str] = None,
                   dtype=torch.bfloat16, extra_paths: Tuple[str, ...] = (),
                   device="cuda"):
    """A Moshi LM checkpoint (safetensors or GGUF, with ``extra_paths``
    searched after it) as the LM's parameter tree on ``device``, the
    weights the policy picks quantized to ``fmt`` (q8_0, q4_0, q4_k,
    q8_r) where the file holds them unquantized."""
    dev = resolve_device(device)
    src = _Source(dev, path, *extra_paths)
    ld = _Loader(src, dev, dtype)
    try:
        params = {
            "text_emb": ld.text_emb("lm.text_emb", cfg.demux_second_stream,
                                    fmt),
            "emb": {"weight": _stack([
                ld.maybe_quant(f"lm.emb.{i}.weight",
                               src.get(f"lm.emb.{i}.weight"), fmt)
                for i in range(cfg.n_q)])},
            "transformer": _lm_transformer_layers(ld, cfg, fmt),
            "out_norm": ld.norm("lm.out_norm"),
            "text_linear": ld.linear("lm.text_linear", fmt),
        }
        if cfg.extra_heads_num:
            params["extra_heads"] = _stack([
                ld.linear(f"lm.extra_heads.{i}", None)
                for i in range(cfg.extra_heads_num)])
        if cfg.dep_q > 0:
            dep = {
                "in": _stack([ld.linear(f"lm.depformer_in.{i}", fmt)
                              for i in range(cfg.depformer_num_weights)]),
                "text_emb": ld.text_emb("lm.depformer_text_emb",
                                        cfg.demux_second_stream, fmt),
                "layers": _depformer_layers(ld, cfg, fmt),
                "linears": _stack([ld.linear(f"lm.linears.{i}", fmt)
                                   for i in range(cfg.dep_q)]),
            }
            if cfg.dep_q > 1:
                dep["emb"] = _stack([
                    ld.text_emb(f"lm.depformer_emb.{i}", False, fmt)
                    for i in range(cfg.dep_q - 1)])
            params["depformer"] = dep
    finally:
        src.close()
    return params


# ---------------------------------------------------------------------------
# GGUF snapshots (the reference's GGUF names: split attention
# projections, derived codebook embeddings, CRC renaming), read back by
# load_lm_params / load_mimi_params
# ---------------------------------------------------------------------------


def _unstack(tree, idx):
    if isinstance(tree, dict):
        return {k: _unstack(v, idx) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return tree._map(lambda a: a[idx])
    return tree[idx]


def _save_float(writer, name, value: torch.Tensor):
    """A float leaf: F32 as it is, else F16 where f16 holds every value,
    else BF16."""
    if value.dtype == torch.float32:
        writer.add_tensor(name, value)
        return
    f32 = value.float()
    f16 = f32.half()
    if torch.equal(f16.float(), f32):
        writer.add_tensor(name, f16)
    else:
        writer.add_tensor(name, value)


def _save_leaf(writer, name, value):
    if isinstance(value, QuantTensor):
        writer.add_tensor(name, value)
    else:
        _save_float(writer, name, value)


def _save_linear(writer, prefix: str, tree):
    _save_leaf(writer, prefix + ".weight", tree["weight"])
    if "bias" in tree:
        _save_float(writer, prefix + ".bias", tree["bias"])


def _save_norm(writer, prefix: str, tree):
    if "alpha" in tree:
        writer.add_tensor(prefix + ".alpha",
                          tree["alpha"].float().reshape(1, 1, -1))
    else:
        writer.add_tensor(prefix + ".weight", tree["weight"].float())
        writer.add_tensor(prefix + ".bias", tree["bias"].float())


def _save_attention(writer, prefix: str, tree):
    _save_leaf(writer, prefix + ".in_projs.0.weight",
               tree["in_proj"]["weight"])
    if "bias" in tree["in_proj"]:
        _save_float(writer, prefix + ".in_projs.0.bias",
                    tree["in_proj"]["bias"])
    _save_leaf(writer, prefix + ".out_projs.0.weight",
               tree["out_proj"]["weight"])
    if "bias" in tree["out_proj"]:
        _save_float(writer, prefix + ".out_projs.0.bias",
                    tree["out_proj"]["bias"])


def _save_text_emb(writer, prefix: str, tree):
    _save_leaf(writer, prefix + ".weight", tree["weight"])
    if "out1" in tree:
        _save_linear(writer, prefix + ".out1", tree["out1"])
        _save_linear(writer, prefix + ".out2", tree["out2"])
    if "low_rank" in tree:
        _save_linear(writer, prefix + ".low_rank", tree["low_rank"])


def save_lm_gguf(path: str, params, cfg: LMConfig,
                 metadata: Optional[dict] = None):
    """Write an LM parameter tree (quantized or not) to GGUF."""
    from moshi_tpu_torch.io.gguf import GGUFWriter
    w = GGUFWriter()
    w.add_kv("general.architecture", "moshi")
    for k, v in (metadata or {}).items():
        w.add_kv(k, v)
    _save_text_emb(w, "lm.text_emb", params["text_emb"])
    for i in range(cfg.n_q):
        _save_leaf(w, f"lm.emb.{i}.weight",
                   _unstack(params["emb"], i)["weight"])
    for i in range(cfg.num_layers):
        lp = f"lm.transformer.layers.{i}"
        layer = _unstack(params["transformer"]["layers"], i)
        _save_norm(w, lp + ".norm1", layer["norm1"])
        _save_norm(w, lp + ".norm2", layer["norm2"])
        _save_attention(w, lp + ".self_attn", layer["self_attn"])
        _save_linear(w, lp + ".gating.linear_in", layer["gating"]["linear_in"])
        _save_linear(w, lp + ".gating.linear_out",
                     layer["gating"]["linear_out"])
        if "cross_attention" in layer:
            _save_norm(w, lp + ".norm_cross", layer["norm_cross"])
            _save_attention(w, lp + ".cross_attention",
                            layer["cross_attention"])
    _save_norm(w, "lm.out_norm", params["out_norm"])
    _save_linear(w, "lm.text_linear", params["text_linear"])
    if "extra_heads" in params:
        for i in range(cfg.extra_heads_num):
            _save_linear(w, f"lm.extra_heads.{i}",
                         _unstack(params["extra_heads"], i))
    if "depformer" in params:
        dep = params["depformer"]
        for i in range(cfg.depformer_num_weights):
            _save_linear(w, f"lm.depformer_in.{i}", _unstack(dep["in"], i))
        _save_text_emb(w, "lm.depformer_text_emb", dep["text_emb"])
        if "emb" in dep:
            for i in range(cfg.dep_q - 1):
                _save_text_emb(w, f"lm.depformer_emb.{i}",
                               _unstack(dep["emb"], i))
        for i in range(cfg.dep_q):
            _save_linear(w, f"lm.linears.{i}", _unstack(dep["linears"], i))
        for i in range(cfg.depformer_layers):
            lp = f"lm.depformer.layers.{i}"
            _save_norm(w, lp + ".norm1", _unstack(dep["layers"]["norm1"], i))
            _save_norm(w, lp + ".norm2", _unstack(dep["layers"]["norm2"], i))
            for j in range(cfg.depformer_num_weights):
                # steps-outer [W, L, ...]
                attn = _unstack(dep["layers"]["self_attn"], (j, i))
                _save_leaf(w, f"{lp}.self_attn.in_projs.{j}.weight",
                           attn["in_proj"]["weight"])
                _save_leaf(w, f"{lp}.self_attn.out_projs.{j}.weight",
                           attn["out_proj"]["weight"])
                gate = _unstack(dep["layers"]["gating"], (j, i))
                _save_linear(w, f"{lp}.gating.{j}.linear_in",
                             gate["linear_in"])
                _save_linear(w, f"{lp}.gating.{j}.linear_out",
                             gate["linear_out"])
    w.write(path)


def save_mimi_gguf(path: str, params, model: MimiModel,
                   metadata: Optional[dict] = None):
    """Write a Mimi parameter tree to GGUF: conv and projection weights in
    f16 (rounded to nearest even where f16 does not hold them), norms,
    layer scales and codebooks in f32."""
    from moshi_tpu_torch.io.gguf import GGUFWriter
    w = GGUFWriter()
    w.add_kv("general.architecture", "mimi")
    for k, v in (metadata or {}).items():
        w.add_kv(k, v)
    cfg = model.cfg

    def save_conv(prefix, tree, mod):
        if isinstance(mod, StreamingConvTranspose1d):
            wt = oiw_to_torch_convtr(tree["weight"].float(), mod.groups)
            _save_float(w, f"{prefix}.convtr.convtr.weight", wt.half())
            if "bias" in tree:
                _save_float(w, f"{prefix}.convtr.convtr.bias", tree["bias"])
        else:
            _save_float(w, f"{prefix}.conv.conv.weight",
                        tree["weight"].float().half())
            if "bias" in tree:
                _save_float(w, f"{prefix}.conv.conv.bias", tree["bias"])

    for net, tree, prefix in ((model.encoder, params["encoder"],
                               "mimi.encoder"),
                              (model.decoder, params["decoder"],
                               "mimi.decoder")):
        for name, mod in net.modules.items():
            save_conv(f"{prefix}.{name}", tree[name], mod)

    for tr in ("encoder_transformer", "decoder_transformer"):
        for i in range(cfg.transformer_layers):
            lp = f"mimi.{tr}.transformer.layers.{i}"
            layer = _unstack(params[tr]["layers"], i)
            _save_norm(w, lp + ".norm1", layer["norm1"])
            _save_norm(w, lp + ".norm2", layer["norm2"])
            _save_attention(w, lp + ".self_attn", layer["self_attn"])
            _save_linear(w, lp + ".linear1", layer["linear1"])
            _save_linear(w, lp + ".linear2", layer["linear2"])
            w.add_tensor(lp + ".layer_scale_1.scale",
                         layer["layer_scale_1"]["scale"].float())
            w.add_tensor(lp + ".layer_scale_2.scale",
                         layer["layer_scale_2"]["scale"].float())

    _save_float(w, "mimi.downsample.conv.conv.conv.weight",
                params["downsample"]["weight"].float().half())
    _save_float(w, "mimi.upsample.convtr.convtr.convtr.weight",
                oiw_to_torch_convtr(params["upsample"]["weight"].float(),
                                    cfg.dim).half())

    for branch, n in (("rvq_first", 1),
                      ("rvq_rest", cfg.total_codebooks - 1)):
        bp = f"mimi.quantizer.{branch}"
        btree = params["quantizer"][branch]
        embs = btree["embeddings"].float()
        for j in range(n):
            w.add_tensor(f"{bp}.vq.layers.{j}._codebook.embedding", embs[j])
        for proj in ("input_proj", "output_proj"):
            pw = btree[proj]["weight"].float()
            _save_float(w, f"{bp}.{proj}.weight", pw[:, :, None].half())
    w.write(path)
