"""K14: the depformer megakernels (q4_k, B = 1).

Counterpart of ``moshi_tpu/nn/pallas_depformer.py``:

- ``dep_full_step`` (kernel body ``_dep_step_kernel``): every layer of one
  depformer step in one launch, the hidden state carried in f32;
- ``dep_layer_step`` (``_dep_layer_kernel``): one layer, the same
  arithmetic (``_maybe_norm`` is the same rms norm), so here it is
  ``dep_full_step`` at one layer;
- ``dep_frame_step`` (``_dep_frame_kernel``): the whole frame of dep_q
  steps, each step's token embedding, layers, logits and sampling, in one
  launch; the sampled token feeds the next step's embedding on the card.

One layer (``_dep_step_kernel`` / ``_dep_layer_body``), on the dequant
arithmetic of ``_q4k_dot`` for q4_k and ``_q4_0_dot`` for a q4_0
linear_out (bf16((q - 8) * d), no min term; ``quant/matmul.py``):

    xn   = rms_norm(h) * n1[l]                      (eps 1e-8)
    q, k, v = W_qkv . xn
    ring[cb] = bf16(k), bf16(v)                     (only where cb < cap)
    s_j  = hd^-0.5 * head sums of bf16(k_j) * bf16(q), j <= cb
    p    = softmax(s)                               (max, exp, sum, divide)
    attn = sum_j bf16(p_j) * v_j
    h2   = h + W_out . attn
    hv   = silu(W_g . xn2) * (W_v . xn2)            xn2 = rms_norm(h2) * n2[l]
    h    = h2 + W_lout . hv

The ring is read after the write, in bf16, so the current row is rounded
too.  The products bf16 x bf16 of the scores and of p * v are exact in
f32 before the f32 sums (``_dep_scores``, ``_dep_values``: the Pallas
kernel casts them to f32, and its interpreter then keeps the bf16
product exact; K13's products, which feed a bf16 contraction, are
rounded instead; the CPU tests tell the two apart).  Masked slots
(j > cb) weigh exactly 0, so the plain versions and the kernels skip
them.  A ring of fewer slots than steps (cap < dep_q) takes no write at
cb >= cap, as the Pallas kernel's ``where(rows == cb)``; the XLA
depformer writes slot cb % cap instead (ROADMAP.md, C).

The frame form: rings [L, cap, dim] start at zero; step 0 adds the text
embedding to h_in[0], step s > 0 the low-rank embedding of the previous
token, emb[s][prev] @ lr_w[s]^T in f32; after the layers the logits are
the dequant product of the step's q4_k linear (``_q4k_dot``, not K1's
int8 arithmetic); at temp 0 the token is the first-index argmax, else
the top-k threshold ``_topk_threshold`` (30 bisection steps) of
logits * (1 / temp) masks the scores to scaled + noise (else -1e9) and
the first-index argmax of those is taken.

On CUDA tensors the wrappers launch ``csrc/dep_step.cu`` (cooperative
launches, one per step for ``dep_full_step``, one per frame for
``dep_frame_step``; counts ``dep_full_step`` and ``dep_frame_step``) and
raise if they cannot; on CPU tensors they run ``dep_full_step_plain`` and
``dep_frame_step_plain``.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.quant.formats import QuantTensor, layout_ok
from moshi_tpu_torch.quant.matmul import _dequant_product, _silu
from moshi_tpu_torch.quant.matmul_int8 import _ACT, _check_operand

NEG = -1e9
BIG_I32 = 2 ** 30
LOUT_FORMATS = ("q4_k", "q4_0")


def _argmax_lane(v: torch.Tensor) -> torch.Tensor:
    """First-index argmax of v [V] (jnp.argmax semantics)."""
    iota = torch.arange(v.shape[-1], device=v.device)
    return torch.min(torch.where(v == v.max(), iota,
                                 torch.full_like(iota, BIG_I32)))


def _topk_threshold(v: torch.Tensor, k: int, iters: int = 30):
    """Value-domain bisection for the k-th largest of v [V]: the returned
    thr keeps count(v >= thr) >= k (the Pallas kernel's, step for step:
    f32 midpoints of [min, max])."""
    lo, hi = v.min(), v.max()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        take = (v >= mid).float().sum() >= k
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    return lo


def sample_scaled(logits, noise, temp: float, top_k: int, card: int):
    """The frame kernel's sampler on logits [card] f32: the first-index
    argmax at temp 0; otherwise scaled = logits * (1 / temp), the top-k
    threshold of scaled, and the first-index argmax of scaled + noise over
    the kept values (-1e9 elsewhere)."""
    if temp == 0.0:
        return _argmax_lane(logits)
    scaled = logits * (1.0 / temp)
    k = min(int(top_k), card) if top_k > 0 else card
    thr = _topk_threshold(scaled, k)
    masked = torch.where(scaled >= thr, scaled + noise.float(),
                         torch.full_like(scaled, NEG))
    return _argmax_lane(masked)


def _dep_scores(k, q, hd: int):
    """Head sums of bf16(k) * bf16(q), the products exact in f32: k
    [n, dd], q [dd] bf16 -> [n, H]."""
    prod = k.float() * q.float()
    return prod.reshape(prod.shape[0], -1, hd).sum(-1)


def _dep_values(p, v, hd: int):
    """sum_j bf16(p_j) * v_j, the products exact in f32: p [n, H] f32,
    v [n, dd] bf16 -> [dd]."""
    pe = torch.repeat_interleave(p.to(torch.bfloat16).float(), hd, dim=1)
    return (pe * v.float()).sum(0)


def _layer_plain(h, k_ring, v_ring, cb: int, w, n: int, n1, n2, heads: int,
                 cap: int):
    """One depformer layer on h [1, dd] f32 with its ring [cap, dd]
    (written in place at row cb), the weights of flat layer ``n``."""
    dd = h.shape[-1]
    hd = dd // heads
    qkv = _dequant_product(h, w["qkv"], n, n1)[0]
    q = qkv[:dd]
    if cb < cap:
        k_ring[cb] = qkv[dd:2 * dd].to(k_ring.dtype)
        v_ring[cb] = qkv[2 * dd:].to(v_ring.dtype)
    nv = min(cb + 1, cap)
    s = _dep_scores(k_ring[:nv], q.to(torch.bfloat16), hd) * (hd ** -0.5)
    p = torch.exp(s - s.amax(0))
    p = p / p.sum(0)
    attn = _dep_values(p, v_ring[:nv], hd)
    h2 = h + _dequant_product(attn[None], w["out"], n)
    gv = _dequant_product(h2, w["glu"], n, n2)
    half = gv.shape[-1] // 2
    hv = _silu(gv[:, :half]) * gv[:, half:]
    return h2 + _dequant_product(hv, w["lout"], n)


def dep_full_step_plain(h, k_cache, v_cache, cb: int, weights, *, cap: int,
                        heads: int, nlayers: int):
    """K14a's arithmetic in PyTorch (the rings written in place)."""
    hh = h.reshape(1, -1).float()
    n1, n2 = weights["n1"].float(), weights["n2"].float()
    for li in range(nlayers):
        hh = _layer_plain(hh, k_cache[li], v_cache[li], cb, weights, li,
                          n1[li], n2[li], heads, cap)
    return hh, k_cache, v_cache


def _check_dep_weights(weights, lead: int):
    for name in ("qkv", "out", "glu"):
        w = weights[name]
        if not (isinstance(w, QuantTensor) and w.fmt == "q4_k"):
            raise ValueError(f"{name} must be q4_k")
    lo = weights["lout"]
    if not (isinstance(lo, QuantTensor) and lo.fmt in LOUT_FORMATS
            and layout_ok(lo)):
        raise ValueError(f"lout must be q4_k or q4_0 with K % 64 == 0")
    for name in ("qkv", "out", "glu", "lout"):
        if weights[name].q.dim() != lead + 2:
            raise ValueError(f"{name} must have {lead} leading axes, got q "
                             f"{tuple(weights[name].q.shape)}")


def dep_full_step(h, k_cache, v_cache, cb, weights, *, cap: int, heads: int,
                  nlayers: int):
    """All depformer layers of one step in one launch.

    h [1, dd]; k/v_cache [L, cap, dd] bf16, written in place at row cb
    (where cb < cap); cb the step index (int); weights: stacked [L, ...]
    ``qkv``, ``out``, ``glu`` (q4_k) and ``lout`` (q4_k or q4_0), norms
    ``n1``, ``n2`` [L, dd].  Returns (h_new [1, dd] f32, k_cache,
    v_cache)."""
    _check_dep_weights(weights, 1)
    cb = int(cb)
    w = {n: weights[n].with_eff_scales() for n in ("qkv", "out", "glu",
                                                   "lout")}
    w["n1"], w["n2"] = weights["n1"], weights["n2"]
    if h.is_cuda:
        return _launch_step(h, k_cache, v_cache, cb, w, cap=cap, heads=heads,
                            nlayers=nlayers)
    return dep_full_step_plain(h, k_cache, v_cache, cb, w, cap=cap,
                               heads=heads, nlayers=nlayers)


def _stack1(tree):
    if isinstance(tree, QuantTensor):
        return tree._map(lambda a: a[None])
    return tree[None]


def dep_layer_step(h, k_cache, v_cache, cb, weights, *, cap: int,
                   heads: int):
    """One depformer layer step: ``dep_full_step`` at one layer.  h
    [1, dd]; k/v_cache [cap, dd]; weights: one layer's ``qkv``, ``out``,
    ``glu``, ``lout`` and norms ``n1``, ``n2`` [dd].  Returns (h_new, k_cache,
    v_cache)."""
    w = {n: _stack1(weights[n]) for n in ("qkv", "out", "glu", "lout")}
    w["n1"] = weights["n1"].reshape(1, -1)
    w["n2"] = weights["n2"].reshape(1, -1)
    y, _, _ = dep_full_step(h, k_cache[None], v_cache[None], cb, w, cap=cap,
                            heads=heads, nlayers=1)
    return y, k_cache, v_cache


def dep_frame_step_plain(h_in_all, text_emb, weights, noise, *, cap: int,
                         heads: int, nlayers: int, card: int, temp: float,
                         top_k: int, logits_out=None):
    """K14c's arithmetic in PyTorch: tokens [dep_q] int32."""
    dep_q, _, dd = h_in_all.shape
    dev = h_in_all.device
    n1, n2 = weights["n1"].float(), weights["n2"].float()
    k_ring = torch.zeros((nlayers, cap, dd), dtype=torch.bfloat16, device=dev)
    v_ring = torch.zeros_like(k_ring)
    tokens = torch.empty((dep_q,), dtype=torch.int32, device=dev)
    prev = None
    for s in range(dep_q):
        if s == 0:
            tok = text_emb.reshape(1, dd).float()
        else:
            e = weights["emb"][s, prev].float()
            tok = (e @ weights["lr_w"][s].float().T)[None]
        h = h_in_all[s].float() + tok
        for li in range(nlayers):
            h = _layer_plain(h, k_ring[li], v_ring[li], s, weights,
                             s * nlayers + li, n1[li], n2[li], heads, cap)
        logits = _dequant_product(h, weights["linears"], s)[0]
        if logits_out is not None:
            logits_out[s] = logits
        prev = sample_scaled(logits, noise[s].reshape(-1), temp, top_k, card)
        tokens[s] = prev
    return tokens


def dep_frame_step(h_in_all, text_emb, weights, noise, *, cap: int,
                   heads: int, nlayers: int, card: int, temp: float,
                   top_k: int, logits_out=None):
    """All depformer steps of one frame in one launch.

    h_in_all [dep_q, 1, dd] (depformer_in of transformer_out, per step);
    text_emb [1, dd]; noise [dep_q, 1, card] Gumbel noise (read only at
    temp > 0); weights: per-step stacked ``qkv``, ``out``, ``glu``,
    ``lout`` [dep_q, L, ...], norms ``n1``, ``n2`` [L, dd], ``emb``
    [dep_q, card + 1, lr] (row 0 unused: step s embeds with emb[s]),
    ``lr_w`` [dep_q, dd, lr], ``linears`` [dep_q, card, dd] q4_k.  Returns
    the sampled tokens [dep_q] int32."""
    _check_dep_weights(weights, 2)
    lin = weights["linears"]
    if not (isinstance(lin, QuantTensor) and lin.fmt == "q4_k"):
        raise ValueError("linears must be q4_k")
    if cap < h_in_all.shape[0]:
        raise ValueError(f"the frame kernel needs a ring of at least dep_q "
                         f"slots, got cap {cap} < {h_in_all.shape[0]}")
    w = {n: weights[n].with_eff_scales()
         for n in ("qkv", "out", "glu", "lout", "linears")}
    for n in ("n1", "n2", "emb", "lr_w"):
        w[n] = weights[n]
    kw = dict(cap=cap, heads=heads, nlayers=nlayers, card=card,
              temp=float(temp), top_k=int(top_k), logits_out=logits_out)
    if h_in_all.is_cuda:
        return _launch_frame(h_in_all, text_emb, w, noise, **kw)
    return dep_frame_step_plain(h_in_all, text_emb, w, noise, **kw)


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

_LOUT_CODE = {"q4_k": 0, "q4_0": 1}
_MAX_CAP = 64


def _weight_args(w, names, dev):
    """(q, s1, s2) pointers of each weight: es/em for q4_k, d for q4_0."""
    out = []
    for name in names:
        qt = w[name]
        _check_operand(qt.q, f"{name} q", (torch.uint8,), dev)
        s1 = qt.es if qt.fmt == "q4_k" else qt.d
        s2 = qt.em if qt.fmt == "q4_k" else None
        _check_operand(s1, f"{name} scale", (torch.bfloat16,), dev)
        if s2 is not None:
            _check_operand(s2, f"{name} min", (torch.bfloat16,), dev)
        out += [build.ptr(qt.q), build.ptr(s1),
                None if s2 is None else build.ptr(s2)]
    return out


def _dims(w, nlead: int, dd: int, cap: int, heads: int):
    """(hidden, checked) of the depformer weights, the per-matrix shapes
    against dd."""
    hd = dd // heads
    if dd % 256 or hd not in (32, 64, 128, 256) or not 1 <= cap <= _MAX_CAP:
        raise ValueError(f"K14 takes dim % 256 == 0, head dim 32-256 and a "
                         f"ring of 1-{_MAX_CAP} slots, got dim {dd}, head "
                         f"dim {hd}, cap {cap}")
    hidden = w["glu"].q.shape[-2] // 2
    for name, o, k in (("qkv", 3 * dd, dd), ("out", dd, dd),
                       ("glu", 2 * hidden, dd), ("lout", dd, hidden)):
        if tuple(w[name].q.shape[nlead:]) != (o, k // 2):
            raise ValueError(f"{name} q {tuple(w[name].q.shape)} does not "
                             f"match dim {dd}, hidden {hidden}")
    return hidden


def _norms(w, nlayers, dd, dev):
    out = []
    for name in ("n1", "n2"):
        n = w[name].reshape(nlayers, dd).contiguous()
        _check_operand(n, name, _ACT, dev)
        out += [build.ptr(n), int(n.dtype == torch.bfloat16)]
    return out


def grid_blocks(dd: int, hidden: int, frame: bool = True, lout: str = "q4_0",
                lib_name: str = "dep_step") -> int:
    """The blocks of K14's cooperative grid on the current device (K14c's
    kernel with ``frame``, else K14a's; linear_out in ``lout``): what its
    launch takes at these shapes."""
    fn = build.entry(lib_name, "mt_dep_grid_blocks", [build.I32] * 4)
    n = fn(dd, hidden, int(frame), _LOUT_CODE[lout])
    if n <= 0:
        build.check(-n, lib_name, f"dep_step grid dim={dd}")
    return n


def _launch_step(h, k_cache, v_cache, cb, w, *, cap, heads, nlayers,
                 lib_name="dep_step"):
    """One launch of K14a; ``lib_name``: the library (another checkout's,
    built beside this one, may be named)."""
    dev = h.device
    dd = h.shape[-1]
    hidden = _dims(w, 1, dd, cap, heads)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_operand(t, name, (torch.bfloat16,), dev)
        if tuple(t.shape) != (nlayers, cap, dd):
            raise ValueError(f"{name} {tuple(t.shape)} != "
                             f"{(nlayers, cap, dd)}")
    if w["qkv"].q.shape[0] != nlayers:
        raise ValueError(f"weights hold {w['qkv'].q.shape[0]} layers, not "
                         f"{nlayers}")
    x = h.reshape(dd).contiguous()
    _check_operand(x, "h", _ACT, dev)
    scratch = torch.empty(3 * dd + dd + hidden, dtype=torch.float32,
                          device=dev)
    h_out = torch.empty((1, dd), dtype=torch.float32, device=dev)
    V, I = build.VP, build.I32
    fn = build.entry(lib_name, "mt_dep_full_step",
                     [V, I, V, V, I] + [V] * 12 + [I, V, I, V, I]
                     + [V, V] + [I] * 5 + [build.F32, V])
    err = fn(build.ptr(x), int(x.dtype == torch.bfloat16),
             build.ptr(k_cache), build.ptr(v_cache), cb,
             *_weight_args(w, ("qkv", "out", "glu", "lout"), dev),
             _LOUT_CODE[w["lout"].fmt], *_norms(w, nlayers, dd, dev),
             build.ptr(h_out), build.ptr(scratch), dd, heads, hidden, cap,
             nlayers, (dd // heads) ** -0.5, build.stream_of(x))
    build.check(err, lib_name, f"dep_full_step dim={dd} L={nlayers} "
                f"cb={cb}")
    build.COUNTS["dep_full_step"] += 1
    return h_out, k_cache, v_cache


def _launch_frame(h_in_all, text_emb, w, noise, *, cap, heads, nlayers, card,
                  temp, top_k, logits_out, lib_name="dep_step"):
    """One launch of K14c; ``lib_name`` as in ``_launch_step``."""
    dev = h_in_all.device
    dep_q, _, dd = h_in_all.shape
    hidden = _dims(w, 2, dd, cap, heads)
    lin = w["linears"]
    if tuple(lin.q.shape) != (dep_q, card, dd // 2):
        raise ValueError(f"linears q {tuple(lin.q.shape)} != "
                         f"{(dep_q, card, dd // 2)}")
    if card % 32 or card > 8192:
        raise ValueError(f"K14c takes a card that is a multiple of 32, at "
                         f"most 8192, got {card}")
    hin = h_in_all.reshape(dep_q, dd).contiguous()
    temb = text_emb.reshape(dd).contiguous()
    emb, lr_w = w["emb"].contiguous(), w["lr_w"].contiguous()
    lr = emb.shape[-1]
    if (emb.shape[:2] != (dep_q, card + 1) or lr_w.shape != (dep_q, dd, lr)
            or lr > 1024):
        raise ValueError(f"emb {tuple(emb.shape)} / lr_w "
                         f"{tuple(lr_w.shape)} do not match dep_q {dep_q}, "
                         f"card {card}, dim {dd}")
    for name, t in (("h_in_all", hin), ("text_emb", temb), ("emb", emb),
                    ("lr_w", lr_w)):
        _check_operand(t, name, _ACT, dev)
    nz = noise.reshape(dep_q, card).to(device=dev, dtype=torch.float32) \
        .contiguous()
    rings = torch.empty((2, nlayers, cap, dd), dtype=torch.bfloat16,
                        device=dev)
    scratch = torch.empty(3 * dd + 2 * dd + hidden + card + 1,
                          dtype=torch.float32, device=dev)
    tokens = torch.empty((dep_q,), dtype=torch.int32, device=dev)
    if logits_out is not None:
        _check_operand(logits_out, "logits_out", (torch.float32,), dev)
        if tuple(logits_out.shape) != (dep_q, card):
            raise ValueError(f"logits_out {tuple(logits_out.shape)} != "
                             f"{(dep_q, card)}")
    # values the sampler keeps (0: greedy), as sample_scaled's k
    k_kept = 0 if temp == 0.0 else (min(top_k, card) if top_k > 0 else card)
    V, I, F = build.VP, build.I32, build.F32
    fn = build.entry(lib_name, "mt_dep_frame_step",
                     [V, V, I, V, I, V, I] + [V] * 15 + [I, V, I, V, I]
                     + [V] * 5 + [I] * 9 + [F, F, V])
    err = fn(build.ptr(hin), build.ptr(temb), int(temb.dtype == torch.bfloat16),
             build.ptr(emb), int(emb.dtype == torch.bfloat16),
             build.ptr(lr_w), int(lr_w.dtype == torch.bfloat16),
             *_weight_args(w, ("qkv", "out", "glu", "lout", "linears"), dev),
             _LOUT_CODE[w["lout"].fmt], *_norms(w, nlayers, dd, dev),
             build.ptr(nz), build.ptr(tokens),
             None if logits_out is None else build.ptr(logits_out),
             build.ptr(rings),
             build.ptr(scratch), dd, heads, hidden, cap, nlayers, dep_q,
             card, lr, k_kept, (dd // heads) ** -0.5,
             0.0 if temp == 0.0 else 1.0 / temp, build.stream_of(hin))
    build.check(err, lib_name, f"dep_frame_step dim={dd} L={nlayers} "
                f"dep_q={dep_q}")
    build.COUNTS["dep_frame_step"] += 1
    return tokens
