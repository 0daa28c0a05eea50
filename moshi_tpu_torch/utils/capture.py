"""Golden-trace capture and compare: the port's debug recorder.

Counterpart of ``moshi_tpu/utils/capture.py``.  Modules call
``capture(name, value)`` at their tap points (``lm/embed``,
``lm/temporal/*``, ``lm/dep/*``, ``mimi/*``; docs/CAPTURE.md), with the JAX
package's names and in its order, so that ``TraceRecorder.order`` of one
frame is the same list in both packages.  While a recorder is active each
tap copies its value to the host at once (``detach``, to the CPU, a numpy
array that owns its memory; bf16 and fp8 widened to f32, which is exact):
the KV rings are written in place after their tap, and a recorder that
kept a view would see the later write.  Traces are saved as .npz and
diffed with the reference's tolerances (replay.h:332-341): ``TOL_CPU`` for
one backend, ``TOL_GPU`` across backends (the JAX module's ``TOL_TPU``).

With no recorder active and ``MOSHI_TPU_DEBUG_SUMS`` unset (it is read once,
when the module is imported), ``capture`` is one Python branch that
returns its argument: no copy, no sync, no launch.
Modules with many taps in a loop (the stacked decode, SEANet) also ask
``recording_active()`` once per call and skip their taps.  While a recorder
is active the fused K5 form is off, in the temporal stack and in the
depformer, so that the intermediate taps exist, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

TOL_CPU = 1e-5   # replay.h:332-341
TOL_GPU = 1e-2

_ACTIVE: Optional["TraceRecorder"] = None
# widened to f32 on the host (exact): numpy has no bf16 or fp8
_WIDEN = (torch.bfloat16, torch.float8_e4m3fn)


# read once, at import: with it unset and no recorder active, a tap costs
# one branch
_DEBUG_SUMS = bool(os.environ.get("MOSHI_TPU_DEBUG_SUMS"))


def recording_active() -> bool:
    """True while a TraceRecorder is active or MOSHI_TPU_DEBUG_SUMS is set:
    the fused forms, which skip intermediate taps, then take the unfused
    tapped ops."""
    return _ACTIVE is not None or _DEBUG_SUMS


def _host_copy(value):
    """(numpy array that owns its memory, the value's dtype name)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype in _WIDEN:
            t = t.float()
        return np.array(t.numpy(), copy=True), name
    arr = np.array(value, copy=True)
    return arr, str(arr.dtype)


def capture(name: str, value):
    """Record ``value`` under ``name`` if a TraceRecorder is active, and
    return it.  With MOSHI_TPU_DEBUG_SUMS set, also print its f32 sum (the
    reference's ctx.debug() probes, context.h:497-518), which syncs."""
    if _ACTIVE is None and not _DEBUG_SUMS:
        return value
    if _DEBUG_SUMS:
        s = (value.detach().float().sum().item()
             if isinstance(value, torch.Tensor)
             else float(np.sum(np.asarray(value, np.float32))))
        print(f"{name}: sum={s}", flush=True)
    if _ACTIVE is not None:
        if name not in _ACTIVE.provenance:
            # the caller's file:line, the reference's per-op provenance
            # (ggml_wrap.h:12-22)
            fr = sys._getframe(1)
            _ACTIVE.provenance[name] = \
                f"{fr.f_code.co_filename}:{fr.f_lineno}"
        _ACTIVE._record(name, value)
    return value


class TraceRecorder:
    def __init__(self):
        self.values: Dict[str, List[np.ndarray]] = defaultdict(list)
        # the dtype name of each recorded value, as the tensor had it
        self.dtypes: Dict[str, List[str]] = defaultdict(list)
        # (name, occurrence) in execution order: the op sequence the replay
        # localizer walks (replay.h:360-385)
        self.order: List[tuple] = []
        # tap name -> "file:line" of its capture() call site
        self.provenance: Dict[str, str] = {}

    def _record(self, name, value):
        name = str(name)
        arr, dtype = _host_copy(value)
        self.order.append((name, len(self.values[name])))
        self.values[name].append(arr)
        self.dtypes[name].append(dtype)

    def save(self, path: str):
        flat = {}
        for name, vals in self.values.items():
            for i, v in enumerate(vals):
                flat[f"{name}@{i}"] = v
        np.savez_compressed(path, **flat)

    def dump_graph(self, path: str):
        """Every recorded tensor (``<path>.npz``) and a JSON sidecar
        (``<path>.json``) with the execution order and each tensor's shape,
        its own dtype and its caller: the reference's GraphDumper
        (ggml_cap.h:1541-1766)."""
        self.save(path if path.endswith(".npz") else path + ".npz")
        doc = {
            "order": [{"name": n, "occurrence": i} for n, i in self.order],
            "tensors": {
                f"{name}@{i}": {
                    "shape": list(v.shape),
                    "dtype": self.dtypes[name][i],
                    "caller": self.provenance.get(name, ""),
                }
                for name, vals in self.values.items()
                for i, v in enumerate(vals)
            },
        }
        jpath = (path[:-4] if path.endswith(".npz") else path) + ".json"
        with open(jpath, "w") as fh:
            json.dump(doc, fh, indent=1)

    @staticmethod
    def load(path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


@contextlib.contextmanager
def recording():
    """with recording() as rec: run steps; rec.values / rec.save(...)"""
    global _ACTIVE
    prev = _ACTIVE
    rec = TraceRecorder()
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = prev


def compare_traces(golden: Dict[str, np.ndarray],
                   test: Dict[str, np.ndarray],
                   tol: float = TOL_CPU):
    """(ok, report lines): each golden tensor against the test's of the
    same name, relative to the golden's largest magnitude (replay.h:360-417's
    per-op compare, then report)."""
    lines = []
    ok = True
    for name in sorted(golden):
        if name not in test:
            lines.append(f"MISSING {name}")
            ok = False
            continue
        g, t = golden[name], test[name]
        if g.shape != t.shape:
            lines.append(f"SHAPE {name}: {g.shape} vs {t.shape}")
            ok = False
            continue
        denom = max(np.abs(g).max(), 1e-8)
        err = np.abs(g.astype(np.float64) - t.astype(np.float64)).max() / denom
        status = "OK" if err <= tol else "FAIL"
        if status == "FAIL":
            ok = False
        lines.append(f"{status} {name}: rel {err:.3e}")
    for name in sorted(set(test) - set(golden)):
        lines.append(f"EXTRA {name}")
    return ok, lines


# ---------------------------------------------------------------------------
# reference capture-dump import
# ---------------------------------------------------------------------------

_GGML_NP = {
    "f32": (np.dtype("<f4"), 4),
    "i32": (np.dtype("<i4"), 4),
    "f16": (np.dtype("<f2"), 2),
    "bf16": (np.dtype("<u2"), 2),   # upcast below
    "i16": (np.dtype("<i2"), 2),
    "i8": (np.dtype("i1"), 1),
}


def load_reference_capture(json_path: str):
    """Parse a reference capture dump (capture/<name>.json + .tensors,
    ggml_cap.h:1541-1766) into (values, meta):

      values: tensor NAME -> float32/int32 numpy array (row-major; ggml's
        ne order is reversed).  Duplicate names keep the LAST occurrence.
      meta: tensor id -> {op, srcs, name, group, caller, shape, type}
        plus meta["__groups__"] and meta["__order__"] (forward_expand ids).

    The .tensors file is resolved next to the .json."""
    with open(json_path) as fh:
        doc = json.load(fh)
    bin_path = os.path.splitext(json_path)[0] + ".tensors"
    with open(bin_path, "rb") as fh:
        blob = fh.read()
    values: Dict[str, np.ndarray] = {}
    meta: Dict[str, dict] = {}
    for tid, rec in doc.get("tensor", {}).items():
        op_name, srcs, params, tinfo = rec[0], rec[1], rec[2], rec[3]
        name, group, caller = rec[4], rec[5], rec[6]
        type_name, ne, offset, nbytes = tinfo[0], tinfo[1], tinfo[2], tinfo[3]
        shape = tuple(reversed([int(d) for d in ne]))
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
        meta[tid] = {"op": op_name, "srcs": list(srcs), "params": params,
                     "name": name, "group": group, "caller": caller,
                     "shape": shape, "type": type_name}
        if nbytes == 0 or type_name not in _GGML_NP:
            continue
        dt, esize = _GGML_NP[type_name]
        n = nbytes // esize
        arr = np.frombuffer(blob, dtype=dt, count=n, offset=offset)
        if type_name == "bf16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        elif type_name == "f16":
            arr = arr.astype(np.float32)
        try:
            arr = arr.reshape(shape)
        except ValueError:
            pass  # strided dumps of padded tensors keep their flat shape
        values[name] = arr
    meta["__groups__"] = doc.get("groups", {})
    meta["__order__"] = doc.get("forward_expand", [])
    return values, meta
