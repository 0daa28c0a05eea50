"""K3: one-query decode attention over a stacked KV ring, read in place.

Counterpart of ``moshi_tpu/nn/pallas_attention.py``
``decode_attention_stacked``.  The rings [L, B, cap, H, hd] hold the
positions before this step (up to ``offset - 1``); the current token's
k/v arrive separately and seed the online softmax, so the ring write can
follow the whole layer loop.  A slot j is valid iff
delta = (last - j) mod cap < context - 1 and last - delta >= 0; masked
scores are -1e9.  The inputs are bf16; their products are formed exactly
in f32 and summed in f32, the probabilities are rounded to bf16 before
they weight the values (as the Pallas kernel's explicit cast does), the
ring is walked in the Pallas kernel's chunks (``chunk_for``), and the
output is f32 [B, H, hd].

On CUDA tensors ``decode_attention_stacked`` launches
``csrc/decode_attention.cu`` (and raises if it cannot); on CPU tensors it
runs ``decode_attention_plain``.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.kernels import build

NEG = -1e9


def chunk_for(cap: int) -> int:
    """Largest divisor of cap <= 256 (the Pallas kernel's ring chunk)."""
    for c in (256, 250, 200, 128, 125, 100, 64, 50, 40, 32, 25, 20, 16,
              10, 8, 5, 4, 2, 1):
        if cap % c == 0:
            return c
    return 1


def decode_attention_stacked(q, k_stack, v_stack, cur_k, cur_v, offset,
                             layer: int, *, cap: int,
                             context: int) -> torch.Tensor:
    """q/cur_k/cur_v [B, H, hd] bf16 (post-rope); k_stack/v_stack
    [L, B, cap, H, hd] bf16 before this step's write; offset [B] int32
    (the current position).  Returns [B, H, hd] f32."""
    b, h, hd = q.shape
    if k_stack.shape[1:] != (b, cap, h, hd) or v_stack.shape != k_stack.shape:
        raise ValueError(f"rings {tuple(k_stack.shape)} do not match q "
                         f"{tuple(q.shape)} at cap {cap}")
    if not 0 <= int(layer) < k_stack.shape[0]:
        raise IndexError(f"layer {layer} of {k_stack.shape[0]}")
    chunk = chunk_for(cap)
    if chunk < 8 and chunk != cap:
        raise ValueError(f"cap {cap} has no usable chunk divisor")
    if q.is_cuda:
        return _launch(q, k_stack, v_stack, cur_k, cur_v, offset, int(layer),
                       cap, context, chunk)
    return decode_attention_plain(q, k_stack[layer], v_stack[layer], cur_k,
                                  cur_v, offset, cap=cap, context=context,
                                  chunk=chunk)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def decode_attention_plain(q, k_ring, v_ring, cur_k, cur_v, offset, *,
                           cap: int, context: int,
                           chunk: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch for one layer's rings
    [B, cap, H, hd]."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    qf = q.float()
    s_cur = (cur_k.float() * qf).sum(-1) * scale                  # [B, H]
    m = s_cur
    lsum = torch.ones_like(s_cur)
    acc = cur_v.float()                                           # [B, H, hd]
    last = offset.long() - 1
    r = torch.remainder(last, cap)
    for c0 in range(0, cap, chunk):
        k = k_ring[:, c0:c0 + chunk].float()                      # [B, C, H, hd]
        v = v_ring[:, c0:c0 + chunk].float()
        s = (k * qf[:, None]).sum(-1) * scale                     # [B, C, H]
        j = torch.arange(c0, c0 + chunk, device=q.device)[None, :]
        delta = torch.where(j > r[:, None], r[:, None] - j + cap,
                            r[:, None] - j)
        valid = (delta < context - 1) & (last[:, None] - delta >= 0)
        s = torch.where(valid[..., None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        lsum = lsum * corr + p.sum(dim=1)
        pv = (_bf16_round(p)[..., None] * v).sum(dim=1)
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / lsum[..., None]


def _launch(q, k_stack, v_stack, cur_k, cur_v, offset, layer, cap, context,
            chunk):
    dev = q.device
    for name, t in (("q", q), ("cur_k", cur_k), ("cur_v", cur_v),
                    ("k_stack", k_stack), ("v_stack", v_stack)):
        if t.device != dev or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if cur_k.shape != q.shape or cur_v.shape != q.shape:
        raise ValueError("cur_k/cur_v must match q")
    b, h, hd = q.shape
    if hd not in (32, 64, 128):
        raise ValueError(f"head dim {hd} not supported (32, 64 or 128)")
    off = offset.to(device=dev, dtype=torch.int32).contiguous()
    if off.shape != (b,):
        raise ValueError(f"offset must be [B], got {tuple(off.shape)}")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    fn = build.entry("decode_attention", "mt_decode_attention", [
        build.VP, build.VP, build.VP, build.VP, build.VP, build.VP, build.VP,
        build.I32, build.I32, build.I32, build.I32, build.I32, build.I32,
        build.I32, build.F32, build.VP])
    err = fn(build.ptr(q), build.ptr(cur_k), build.ptr(cur_v),
             build.ptr(k_stack), build.ptr(v_stack), build.ptr(off),
             build.ptr(out), b, h, hd, cap, context, chunk, layer,
             hd ** -0.5, build.stream_of(q))
    build.check(err, "decode_attention",
                f"decode attention B={b} H={h} hd={hd} cap={cap}")
    build.COUNTS["decode_attention"] += 1
    return out
