"""K4: in-place slot write into stacked KV rings.

Counterpart of ``moshi_tpu/nn/pallas_ring.py`` ``ring_write_stacked``.
The JAX kernel aliased its outputs to the ring inputs so that only the
written blocks moved; here the ring tensors are mutated in place, and the
function returns them for symmetry with the JAX signature.

On CUDA tensors it launches ``csrc/ring_write.cu`` (and raises if it
cannot); on CPU tensors it runs ``ring_write_plain``.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.kernels import build


def ring_write_stacked(k_stack, v_stack, ks, vs, slot):
    """Write ks/vs [L, B, H, hd] into k_stack/v_stack [L, B, cap, H, hd]
    at per-session slots ``slot`` [B], in place.  Returns the rings."""
    l, b, cap, h, hd = k_stack.shape
    if v_stack.shape != k_stack.shape or ks.shape != (l, b, h, hd) or \
            vs.shape != ks.shape:
        raise ValueError(f"ring {tuple(k_stack.shape)} and rows "
                         f"{tuple(ks.shape)} do not match")
    if k_stack.is_cuda:
        _launch(k_stack, v_stack, ks, vs, slot)
    else:
        ring_write_plain(k_stack, v_stack, ks, vs, slot)
    return k_stack, v_stack


def ring_write_plain(k_stack, v_stack, ks, vs, slot):
    bi = torch.arange(k_stack.shape[1], device=k_stack.device)
    s = slot.to(device=k_stack.device, dtype=torch.long)
    k_stack[:, bi, s] = ks.to(k_stack.dtype)
    v_stack[:, bi, s] = vs.to(v_stack.dtype)


def _launch(k_stack, v_stack, ks, vs, slot):
    dev = k_stack.device
    l, b, cap, h, hd = k_stack.shape
    for name, t in (("k_stack", k_stack), ("v_stack", v_stack), ("ks", ks),
                    ("vs", vs)):
        if t.device != dev or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    s = slot.to(device=dev, dtype=torch.int32).contiguous()
    if s.shape != (b,):
        raise ValueError(f"slot must be [B], got {tuple(s.shape)}")
    fn = build.entry("ring_write", "mt_ring_write", [
        build.VP, build.VP, build.VP, build.VP, build.VP, build.I32,
        build.I32, build.I32, build.I32, build.VP])
    err = fn(build.ptr(k_stack), build.ptr(v_stack), build.ptr(ks),
             build.ptr(vs), build.ptr(s), l, b, cap, h * hd,
             build.stream_of(k_stack))
    build.check(err, "ring_write", f"ring write L={l} B={b} cap={cap}")
    build.COUNTS["ring_write"] += 1
