"""K13: the whole q4_k temporal stack for one frame (B = 1, T = 1) in one
launch.

Counterpart of ``moshi_tpu/nn/pallas_temporal.py`` (``plan_stages``,
``temporal_full_step``, kernel body ``_temporal_kernel``).  Per layer,
with the hidden state carried in f32 from layer to layer:

    xn   = rms_norm(h) * n1[l]                      (eps 1e-8)
    qkv  = W_qkv[l] . xn                            (dequant product)
    q, k = rope(q), rope(k)                         (interleaved pairs)
    attn = softmax over the ring and the current token, walked in chunks
    h2   = h + W_out[l] . attn
    hv   = silu(W_g[l] . xn2) * (W_v[l] . xn2)      xn2 = rms_norm(h2) * n2[l]
    h    = h2 + W_lout[l] . hv

Every product is the dequant arithmetic of the Pallas kernel's
``_q4k_dot`` (``quant/matmul.py``'s plain version): the activation rounded
to bf16, each weight element bf16(q * es), products summed in f32, minus
the 32-block sums of the f32 activation times em.

The attention, in the Pallas kernel's order:

- the current token is never in the ring passed in: the online softmax
  is seeded with it, m = s0, l = 1, acc = v (the f32 v row), where s0 is
  the head sums of bf16(k * q) (the f32 product, then rounded) times
  hd^-0.5;
- the ring [L, cap_pad, dim] is walked in chunks of ``plan_stages``'s
  chunk, min(512, cap rounded up to 128); a slot j of a chunk scores the
  head sums, in f32, of the bf16 products bf16(k_j) * bf16(q), each
  rounded to bf16 (``_bf16_product``), times hd^-0.5; it is valid iff
  delta < context, offset - delta >= 0, j < cap and j != r, with
  r = offset % cap and delta = r - j (+ cap if j > r); a masked score is
  -1e9;
- per chunk: m_new = max(m, chunk max), corr = exp(m - m_new),
  p = exp(s - m_new), l = l * corr + sum(p), acc = acc * corr +
  sum(bf16(p) * v) with each product rounded to bf16 and the sum in f32;
  then attn = acc / l.

The rings are bf16 or float8_e4m3fn (``LMConfig.kv_dtype``).  An fp8
ring is widened exactly before the same arithmetic, as the Pallas kernel
widens each chunk to bf16.  The kernel returns every layer's post-rope k
and its v, cast to the ring dtype (fp8 by ``nn/ring.py`` ``fp8_cast``:
XLA's rule, NaN past 464), and the caller writes them into the ring at
slot offset % cap after the launch (``nn/transformer.py``).

On a CUDA tensor ``temporal_full_step`` launches ``csrc/temporal_step.cu``
(one cooperative launch; raises if it cannot) and counts it as
``temporal_full_step``, or ``temporal_full_step_fp8`` on fp8 rings; on a
CPU tensor it runs ``temporal_full_step_plain``.
"""

from __future__ import annotations

import functools
import os

import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.nn.ring import check_rings, ring_bytes, to_ring_dtype
from moshi_tpu_torch.quant.matmul import _dequant_product, _silu
from moshi_tpu_torch.quant.matmul_int8 import _ACT, _check_operand

NEG = -1e9


@functools.lru_cache(maxsize=None)
def plan_stages(dd: int, hidden: int, cap: int):
    """The Pallas kernel's static stage plan: (tq, to, tg, tl, chunk,
    cap_pad, nq, na, no, ng, nl).  MOSHI_TPU_TEMPORAL_TILES
    ("tq=1024,chunk=256,...") overrides the targets and is read once per
    process, as in the JAX package.  Of these only ``chunk`` (the
    attention's ring chunk, which the online softmax rounds against) and
    ``cap_pad`` (cap rounded up to a chunk multiple, the rings' length)
    change what the kernel computes; the row tiles only cut the weight
    streaming on the TPU."""
    ov = {}
    for kv in os.environ.get("MOSHI_TPU_TEMPORAL_TILES", "").split(","):
        if "=" in kv:
            k, v = kv.split("=")
            ov[k.strip()] = int(v)

    def tile(total, target):
        for t in range(target, 0, -128):
            if t <= total and total % t == 0:
                return t
        return total
    tq = tile(dd, ov.get("tq", 2048))
    to = tile(dd, ov.get("to", 2048))
    tg = tile(hidden, ov.get("tg", 5632))
    tl = tile(dd, ov.get("tl", 2048))
    chunk = min(ov.get("chunk", 512), -(-cap // 128) * 128)
    cap_pad = -(-cap // chunk) * chunk
    nq = 3 * dd // tq
    na = cap_pad // chunk
    no = dd // to
    ng = hidden // tg
    nl = dd // tl
    return tq, to, tg, tl, chunk, cap_pad, nq, na, no, ng, nl


def rope_tables(cos_sin, heads: int):
    """(cos, sin) [1, hd/2] -> per-lane f32 tables [dd]: interleaved pairs
    share an angle, and sin is sign-folded (-sin at even lanes), so that
    rope(x) = x * cos + pairswap(x) * sin_m."""
    cos, sin = cos_sin
    cos_f = torch.repeat_interleave(cos.reshape(-1).float(), 2).repeat(heads)
    sin_h = torch.repeat_interleave(sin.reshape(-1).float(), 2).repeat(heads)
    sgn = torch.ones_like(sin_h)
    sgn[0::2] = -1.0
    return cos_f, sin_h * sgn


def _rope(x, cos_f, sin_m):
    sw = x.reshape(-1, 2).flip(-1).reshape(x.shape)      # pair swap
    return x * cos_f + sw * sin_m


def _bf16_product(a, b):
    """The bf16 product of two bf16-valued tensors, as f32: the Pallas
    kernel multiplies bf16 by bf16, and its interpreter rounds that
    product to bf16 (unlike XLA's fused code, which keeps it in f32; the
    CPU tests tell the two apart)."""
    return (a.float() * b.float()).to(torch.bfloat16).float()


def _head_scores(k, q, hd: int):
    """Head sums, in f32, of bf16(k) * bf16(q): k [C, dd], q [dd] bf16
    values -> [C, H]."""
    prod = _bf16_product(k, q)
    return prod.reshape(prod.shape[0], -1, hd).sum(-1)


def _weighted_values(p, v, hd: int):
    """sum_j bf16(p_j) * v_j over a chunk, each product a bf16 product,
    summed in f32: p [C, H] f32, v [C, dd] bf16 values -> [dd]."""
    pe = torch.repeat_interleave(p.to(torch.bfloat16), hd, dim=1)
    return _bf16_product(pe, v).sum(0)


def temporal_full_step_plain(h, k_cache, v_cache, offset, cos_sin, weights,
                             *, cap: int, context: int, heads: int,
                             hidden: int, nlayers: int):
    """K13's arithmetic in PyTorch (see the module docstring)."""
    dd = h.shape[-1]
    hd = dd // heads
    chunk, cap_pad = plan_stages(dd, hidden, cap)[4:6]
    scale = hd ** -0.5
    cos_f, sin_m = rope_tables(cos_sin, heads)
    off = int(offset)
    r = off % cap
    n1, n2 = weights["n1"].float(), weights["n2"].float()
    qkv_w, out_w = weights["qkv"], weights["out"]
    glu_w, lout_w = weights["glu"], weights["lout"]
    hcur = h.reshape(1, dd).float()
    k_new = torch.empty((nlayers, 1, dd), dtype=k_cache.dtype,
                        device=h.device)
    v_new = torch.empty_like(k_new)
    j_all = torch.arange(cap_pad, device=h.device)
    delta = torch.where(j_all > r, r - j_all + cap, r - j_all)
    valid = ((delta < context) & (off - delta >= 0) & (j_all < cap)
             & (j_all != r))
    for li in range(nlayers):
        qkv = _dequant_product(hcur, qkv_w, li, n1[li])[0]
        q = _rope(qkv[:dd], cos_f, sin_m)
        k = _rope(qkv[dd:2 * dd], cos_f, sin_m)
        v = qkv[2 * dd:]
        ring_bytes(k_new)[li, 0] = ring_bytes(to_ring_dtype(k, k_new.dtype))
        ring_bytes(v_new)[li, 0] = ring_bytes(to_ring_dtype(v, v_new.dtype))
        s0 = (k * q).to(torch.bfloat16).float().reshape(heads, hd) \
            .sum(-1) * scale
        m, lsum, acc = s0, torch.ones_like(s0), v.clone()
        qb = q.to(torch.bfloat16)
        for c0 in range(0, cap_pad, chunk):
            kc = k_cache[li, c0:c0 + chunk]
            sc = _head_scores(kc, qb, hd) * scale
            sc = torch.where(valid[c0:c0 + chunk, None], sc,
                             torch.full_like(sc, NEG))
            m_new = torch.maximum(m, sc.amax(0))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            lsum = lsum * corr + p.sum(0)
            acc = (acc * torch.repeat_interleave(corr, hd)
                   + _weighted_values(p, v_cache[li, c0:c0 + chunk], hd))
            m = m_new
        attn = acc / torch.repeat_interleave(lsum, hd)
        h2 = hcur + _dequant_product(attn[None], out_w, li)
        gv = _dequant_product(h2, glu_w, li, n2[li])
        hv = _silu(gv[:, :hidden]) * gv[:, hidden:]
        hcur = h2 + _dequant_product(hv, lout_w, li)
    return hcur, k_new, v_new


def temporal_full_step(h, k_cache, v_cache, offset, cos_sin, weights, *,
                       cap: int, context: int, heads: int, hidden: int,
                       nlayers: int):
    """One temporal frame step, all layers in one launch.

    h [1, dd] (post-embedding); k/v_cache [L, cap_pad, dd] flat head-major
    rings (bf16 or fp8) before this step's write; offset [] or [1] int32; cos_sin (cos,
    sin) [1, hd/2], the rope angles of this position; weights: stacked
    [L, ...] q4_k QuantTensors ``qkv``, ``out``, ``glu``, ``lout`` and the
    norms ``n1``, ``n2`` [L, dd].  Returns (h_out [1, dd] f32, k_new
    [L, 1, dd], v_new [L, 1, dd]) in the rings' dtype."""
    dd = h.shape[-1]
    cap_pad = plan_stages(dd, hidden, cap)[5]
    # plan_stages reads MOSHI_TPU_TEMPORAL_TILES once per process: rings
    # allocated under another plan must fail, not be misread
    if k_cache.shape[1] != cap_pad:
        raise ValueError(
            f"KV ring cap_pad {k_cache.shape[1]} != plan cap_pad {cap_pad}"
            " (state was allocated under a different tile plan; "
            "MOSHI_TPU_TEMPORAL_TILES is read once per process)")
    for name in ("qkv", "out", "glu", "lout"):
        if weights[name].fmt != "q4_k":
            raise ValueError(f"temporal_full_step takes q4_k weights, got "
                             f"{weights[name].fmt} for {name}")
    kw = dict(cap=cap, context=context, heads=heads, hidden=hidden,
              nlayers=nlayers)
    w = {name: (weights[name].with_eff_scales()
                if name not in ("n1", "n2") else weights[name])
         for name in ("qkv", "out", "glu", "lout", "n1", "n2")}
    if h.is_cuda:
        return _launch(h, k_cache, v_cache, offset, cos_sin, w, **kw)
    return temporal_full_step_plain(h, k_cache, v_cache, offset, cos_sin, w,
                                    **kw)


def grid_blocks(dd: int, hidden: int, cap: int, fp8: bool = False,
                lib_name: str = "temporal_step") -> int:
    """The blocks of K13's cooperative grid on the current device (as
    many as can be co-resident): what its launch takes at these shapes."""
    chunk = plan_stages(dd, hidden, cap)[4]
    fn = build.entry(lib_name, "mt_temporal_grid_blocks",
                     [build.I32, build.I32, build.I32, build.I32])
    n = fn(dd, hidden, chunk, int(fp8))
    if n <= 0:
        build.check(-n, lib_name, f"temporal_full_step grid dim={dd}")
    return n


def _launch(h, k_cache, v_cache, offset, cos_sin, w, *, cap, context, heads,
            hidden, nlayers, lib_name="temporal_step"):
    """One launch of K13; ``lib_name``: the library (another checkout's,
    built beside this one, may be named)."""
    dev = h.device
    dd = h.shape[-1]
    hd = dd // heads
    chunk, cap_pad = plan_stages(dd, hidden, cap)[4:6]
    if dd % 256 or hd not in (32, 64, 128, 256) or hidden % 32:
        raise ValueError(f"K13 takes dim % 256 == 0 and head dim 32-256, "
                         f"got dim {dd}, head dim {hd}, hidden {hidden}")
    if chunk > 1024:
        raise ValueError(f"K13 takes ring chunks of at most 1024, got "
                         f"{chunk}")
    shape = (nlayers, cap_pad, dd)
    fp8 = check_rings(dev, (("k_cache", k_cache), ("v_cache", v_cache)))
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    x = h.reshape(dd).contiguous()
    _check_operand(x, "h", _ACT, dev)
    rows = {"qkv": 3 * dd, "out": dd, "glu": 2 * hidden, "lout": dd}
    ks = {"qkv": dd, "out": dd, "glu": dd, "lout": hidden}
    for name, o in rows.items():
        qt = w[name]
        if tuple(qt.q.shape) != (nlayers, o, ks[name] // 2):
            raise ValueError(f"{name} q {tuple(qt.q.shape)} != "
                             f"{(nlayers, o, ks[name] // 2)}")
        _check_operand(qt.q, f"{name} q", (torch.uint8,), dev)
        _check_operand(qt.es, f"{name} es", (torch.bfloat16,), dev)
        _check_operand(qt.em, f"{name} em", (torch.bfloat16,), dev)
    n1 = w["n1"].reshape(nlayers, dd).contiguous()
    n2 = w["n2"].reshape(nlayers, dd).contiguous()
    _check_operand(n1, "n1", _ACT, dev)
    _check_operand(n2, "n2", _ACT, dev)
    cos, sin = (t.reshape(hd // 2).to(device=dev, dtype=torch.float32)
                .contiguous() for t in cos_sin)
    off = offset.reshape(1).to(device=dev, dtype=torch.int32).contiguous()
    nch = cap_pad // chunk
    scratch = torch.empty(
        3 * dd + heads * cap_pad + heads + 2 * heads * nch + nch * dd + dd
        + hidden + dd + heads, dtype=torch.float32, device=dev)
    h_out = torch.empty((1, dd), dtype=torch.float32, device=dev)
    k_new = torch.empty((nlayers, 1, dd), dtype=k_cache.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    qkv, out, glu, lout = (w[n] for n in ("qkv", "out", "glu", "lout"))
    V, I = build.VP, build.I32
    fn = build.entry(lib_name, "mt_temporal_full_step",
                     [V, I, V, V, V, V, V] + [V] * 12
                     + [V, I, V, I] + [V] * 4 + [I] * 8 + [build.F32, I, V])
    err = fn(build.ptr(x), int(x.dtype == torch.bfloat16),
             build.ptr(k_cache), build.ptr(v_cache), build.ptr(off),
             build.ptr(cos), build.ptr(sin),
             *(build.ptr(t) for qt in (qkv, out, glu, lout)
               for t in (qt.q, qt.es, qt.em)),
             build.ptr(n1), int(n1.dtype == torch.bfloat16), build.ptr(n2),
             int(n2.dtype == torch.bfloat16),
             build.ptr(h_out), build.ptr(k_new), build.ptr(v_new),
             build.ptr(scratch), dd, heads, hidden, cap, cap_pad, context,
             chunk, nlayers, hd ** -0.5, int(fp8), build.stream_of(x))
    name = "temporal_full_step_fp8" if fp8 else "temporal_full_step"
    build.check(err, lib_name, f"{name} dim={dd} L={nlayers} cap={cap}")
    build.COUNTS[name] += 1
    return h_out, k_new, v_new
