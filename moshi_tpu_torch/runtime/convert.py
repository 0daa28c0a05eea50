"""Parameter trees from numpy.

``params_from_numpy`` turns a parameter tree whose leaves are numpy arrays
into the port's tree of tensors.  A quantized weight arrives as a dict of
its fields (``fmt``, ``shape``, ``q``, ``d`` and, where present, ``sc``,
``mn``, ``dmin``, ``es``, ``em``) and becomes a ``QuantTensor`` with the
same bytes, in its storage: a 4-bit weight whose ``q`` is int8 (the JAX
package's ``with_i8_storage``) stays unpacked.  bf16 and float8_e4m3fn arrays (ml_dtypes' extension
dtypes, which numpy holds by name) are reinterpreted bit for bit.  The
tree's keys are the JAX package's, so a tree exported from it with
``np.asarray`` on every leaf converts as is:
the LM's (with the cross-attention TTS class's ``norm_cross`` and
``cross_attention`` leaves), Mimi's and the TTS conditioners' (plain
nested dicts of arrays, no quantized leaves).

``gen_state_from_numpy`` does the same for the JAX package's LM
generation state (``init_gen_state``'s tree, its leaves as numpy): the
KV rings in either layout, the stacked [L, B, cap, H, hd] or the
megakernel's flat [L, cap_pad, dim], bf16 or fp8 (``kv_dtype``), the
delay cache and the offsets; the JAX state's threefry key has no
counterpart (the port samples from a ``torch.Generator``) and is
dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.quant.formats import QuantTensor

_QT_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


# ml_dtypes' extension dtypes by name: (the integer view of the same
# width, the torch dtype of the bits)
_BIT_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bf16 and float8_e4m3fn
    keep their bits."""
    a = np.array(a, order="C")       # a writable copy the tensor may own
    if a.dtype.name in _BIT_VIEWS:
        ints, dtype = _BIT_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(ints)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's parameter tree on ``device`` from a numpy tree."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict) and "fmt" in node:
            comps = {f: None if node.get(f) is None
                     else tensor_from_numpy(node[f], dev)
                     for f in _QT_FIELDS}
            return QuantTensor(node["fmt"], tuple(node["shape"]), **comps)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return walk(tree)


def gen_state_from_numpy(state, device="cuda"):
    """The port's LM generation state on ``device`` from the JAX package's
    (numpy leaves): rings as they are, the cache as int64, the offsets as
    int32."""
    dev = resolve_device(device)
    return {
        "transformer": {name: tensor_from_numpy(state["transformer"][name],
                                                dev)
                        for name in ("k", "v")},
        "cache": tensor_from_numpy(state["cache"], dev).long(),
        "offset": tensor_from_numpy(state["offset"], dev).int(),
    }
