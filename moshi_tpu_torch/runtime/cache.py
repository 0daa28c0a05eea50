"""The quantized-model disk cache: a parameter tree in one safetensors file.

Counterpart of ``moshi_tpu/runtime/cache.py``, in the same file format, so
that both packages write the same bytes for the same tree and each reads
the other's.  Each leaf is keyed by its path in the tree, "a/b/c", the
leaves in the JAX package's flattening order (every dict's keys sorted);
a QuantTensor leaf is stored as its fields (``path#field``) with its
format and shape in the header's metadata (``moshi_tpu.quant``), bf16
tensors as BF16.  ``load_quantized`` maps the file and rebuilds the tree
on the device, with no re-quantization.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.io.safetensors import SafeTensors, save_safetensors
from moshi_tpu_torch.quant.formats import QuantTensor

_QT_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in sorted-key order, QuantTensors as leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _host(t: torch.Tensor):
    """A tensor as a host array; bf16 as its raw bits with "BF16"."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().view(np.uint16), "BF16")
    return t.numpy()


def save_quantized(path: str, params, metadata: Dict[str, str] | None = None):
    tensors: Dict[str, Any] = {}
    qt_meta: Dict[str, Any] = {}
    for key, leaf in _leaves(params):
        if isinstance(leaf, QuantTensor):
            qt_meta[key] = {"fmt": leaf.fmt, "shape": list(leaf.shape)}
            for f in _QT_FIELDS:
                arr = getattr(leaf, f)
                if arr is not None:
                    tensors[f"{key}#{f}"] = _host(arr)
        else:
            tensors[key] = _host(leaf)
    meta = dict(metadata or {})
    meta["moshi_tpu.quant"] = json.dumps(qt_meta)
    save_safetensors(path, tensors, metadata=meta)


def load_quantized(path: str, device="cuda"):
    """The nested dict parameter tree of a cache file, on ``device``."""
    dev = resolve_device(device)
    st = SafeTensors(path)
    qt_meta = json.loads(st._meta.get("moshi_tpu.quant", "{}"))
    tree: Dict[str, Any] = {}

    def insert(root, key_path, value):
        parts = key_path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def tensor(name):
        t = torch.from_numpy(st[name]).to(dev)
        return t.to(torch.bfloat16) if st.dtype(name) == "BF16" else t

    qt_fields: Dict[str, Dict[str, torch.Tensor]] = {}
    try:
        for name in list(st.keys()):
            if "#" in name:
                base, field = name.rsplit("#", 1)
                qt_fields.setdefault(base, {})[field] = tensor(name)
            else:
                insert(tree, name, tensor(name))
    finally:
        st.close()
    for base, fields in qt_fields.items():
        info = qt_meta[base]
        insert(tree, base, QuantTensor(info["fmt"], tuple(info["shape"]),
                                       **{f: fields.get(f)
                                          for f in _QT_FIELDS}))
    return tree
