"""K9's split form (``csrc/decode_attention.cu`` ``split_kernel`` with
POST set) against the walk, on the CPU.

On the card K9 runs one block per (session, head, chunk) of its ring
(chunk min(256, cap), the last chunk cut at cap, so 750 slots are chunks
of 256, 256 and 238): each block forms its chunk's p, sum p and p . v
against the walk's running max before the chunk (the prefix max: -1e9,
then the maxima of the valid chunks before it), and the last block of a
(session, head) folds the chunks' parts in the walk's order from l = 0,
acc = 0.  ``split4`` below is that arithmetic in PyTorch, with no running
state across chunks but the prefix max (``cummax``: the max of exact
values is the same in any order).  It must equal the sequential plain
version ``decode_attention4_plain`` bit for bit; a control that rounds p
against each chunk's own max (and rescales the chunk's parts after) must
not.  Also K9's ``launch_plan`` with ragged chunks and its live chunks.
"""

import numpy as np
import pytest
import torch

from moshi_tpu_torch.nn import decode_attention as da

FP8 = torch.float8_e4m3fn
H, HD = 2, 16    # narrow heads; the rings' caps are the stt-1b's and TTS's


def split4(q, kc, vc, offset, *, cap: int, context: int,
           own_max: bool = False) -> torch.Tensor:
    """K9's split arithmetic for rings [B, cap, H, hd]; ``own_max``: the
    control, which also returns whether it rescaled a live chunk (where a
    chunk's max lies below the running max before it; elsewhere it is the
    walk's arithmetic).  The last chunk is padded as the plain version pads it (its
    padded slots are masked, p = 0 there), so that both sum the same
    elements."""
    chunk = da.chunk4_for(cap)
    b, h, hd = q.shape
    scale = hd ** -0.5
    qf = q.to(torch.bfloat16).float()
    off = offset.long()
    r = torch.remainder(off, cap)
    scores, values, live = [], [], []
    for c0 in range(0, cap, chunk):
        k = kc[:, c0:c0 + chunk].float()                          # [B, n, H, hd]
        v = vc[:, c0:c0 + chunk].float()
        pad = chunk - k.shape[1]
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        s = (k * qf[:, None]).sum(-1) * scale                     # [B, C, H]
        j = torch.arange(c0, c0 + chunk)[None, :]
        delta = torch.where(j > r[:, None], r[:, None] - j + cap,
                            r[:, None] - j)
        valid = (delta < context) & (off[:, None] - delta >= 0) & (j < cap)
        scores.append(torch.where(valid[..., None], s,
                                  torch.full_like(s, da.NEG)))
        values.append(v)
        live.append(valid.any(1))                                 # [B]
    cmax = torch.stack([s.amax(1) for s in scores])               # [N, B, H]
    live = torch.stack(live)                                      # [N, B]
    # the prefix max: -1e9, then each live chunk's max
    seen = torch.where(live[..., None], cmax,
                       torch.full_like(cmax, -float("inf")))
    start = torch.full_like(cmax[:1], da.NEG)
    prefix = torch.cummax(torch.cat([start, seen[:-1]]), 0).values
    parts, rescaled = [], False
    for c, (s, v) in enumerate(zip(scores, values)):   # each chunk alone
        m_new = torch.maximum(prefix[c], cmax[c])
        corr = torch.exp(prefix[c] - m_new)
        if own_max:
            p = torch.exp(s - cmax[c][:, None])
            rescale = torch.exp(cmax[c] - m_new)
            rescaled |= bool((live[c][:, None] & (rescale < 1)).any())
            psum = p.sum(dim=1) * rescale
            pv = (da._bf16_round(p)[..., None] * v).sum(dim=1) \
                * rescale[..., None]
        else:
            p = torch.exp(s - m_new[:, None])
            psum = p.sum(dim=1)
            pv = (da._bf16_round(p)[..., None] * v).sum(dim=1)
        parts.append((corr, psum, pv))
    # the fold, in the walk's order, from l = 0, acc = 0; a chunk with no
    # valid slot is skipped
    lsum = torch.zeros((b, h))
    acc = torch.zeros((b, h, hd))
    for c, (corr, psum, pv) in enumerate(parts):
        keep = live[c][:, None]
        lsum = torch.where(keep, lsum * corr + psum, lsum)
        acc = torch.where(keep[..., None], acc * corr[..., None] + pv, acc)
    out = acc / lsum[..., None]
    return (out, rescaled) if own_max else out


def _case(offsets, cap, *, dtype=torch.bfloat16, seed=0, h=H, hd=HD):
    """q [B, H, hd] bf16, rings [B, cap, H, hd] (bf16 or fp8) and the
    offsets, drawn with numpy."""
    rng = np.random.default_rng(seed)
    b = len(offsets)

    def t(shape, to):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32)).to(to)

    q = t((b, h, hd), torch.bfloat16)
    kc, vc = (t((b, cap, h, hd), dtype) for _ in range(2))
    return q, kc, vc, torch.tensor(offsets, dtype=torch.int32)


# (label, cap, offsets, context): the stt-1b's ring (750: chunks 256, 256,
# 238), the TTS ring (500: 256, 244) and a ring of one chunk (200); fresh,
# partly filled and wrapped rings, a chunk fully masked before or after
# the live ones (a context shorter than the ring), mixed ages
STATES = [
    ("stt fresh", 750, [0], 750),
    ("stt first chunk", 750, [93], 750),
    ("stt at a chunk boundary", 750, [256], 750),
    ("stt partly filled", 750, [500], 750),
    ("stt ragged chunk live", 750, [700], 750),
    ("stt full", 750, [749], 750),
    ("stt wrapped", 750, [787], 750),
    ("stt wrapped twice", 750, [2 * 750 + 9], 750),
    ("stt leading chunk masked", 750, [600], 200),
    ("stt trailing chunk masked", 750, [2 * 750 + 400], 180),
    ("tts wrapped", 500, [500 + 37], 500),
    ("tts B = 4 at mixed ages", 500, [3, 255, 256, 2 * 500 + 250], 500),
    ("one chunk", 200, [150], 200),
    ("one chunk, wrapped", 200, [433], 200),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, FP8],
                         ids=["bf16", "fp8"])
@pytest.mark.parametrize("state", STATES, ids=[s[0] for s in STATES])
def test_split_form_equals_the_walk(state, dtype):
    _, cap, offsets, context = state
    q, kc, vc, off = _case(offsets, cap, dtype=dtype,
                           seed=cap + offsets[0] + len(offsets))
    want = da.decode_attention4_plain(q, kc, vc, off, cap=cap,
                                      context=context)
    got = split4(q, kc, vc, off, cap=cap, context=context)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
    # the control: p rounded against each chunk's own max, which differs
    # wherever it rescales a chunk (``test_control_moves_the_boundary_case``
    # holds it on a ring built for it)
    ctl, rescaled = split4(q, kc, vc, off, cap=cap, context=context,
                           own_max=True)
    if rescaled:
        assert not torch.equal(ctl, want)


@pytest.mark.parametrize("h,hd", [(1, 32), (3, 64)])
def test_split_form_at_other_widths(h, hd):
    q, kc, vc, off = _case([2 * 750 + 9], 750, h=h, hd=hd, seed=hd)
    want = da.decode_attention4_plain(q, kc, vc, off, cap=750, context=750)
    assert torch.equal(split4(q, kc, vc, off, cap=750, context=750), want)


def boundary_case(cap: int, h: int, hd: int):
    """A wrapped ring on which the control must move the output by far
    more than an ulp (``chip_smoke.k9_boundary_case``'s construction):
    each query is 8 on one dimension and 0 elsewhere, so every score is
    one exact product; every head's key is 16 at slot 5 (chunk 0, the
    running max from there on) and ``a0`` at slot chunk + 5 (chunk 1) on
    all dimensions, their values -1 and +1.  The walk rounds chunk 1's
    p = exp(s0 - s1) to bf16; the control rounds 1 there and scales it in
    f32.  ``a0`` is the value below 16 whose p has the largest bf16
    rounding error."""
    bf = torch.bfloat16
    scale = hd ** -0.5
    s1 = torch.tensor([8.0 * 16.0]) * scale
    best = (0.0, 15.0)
    for i in range(1, 32):
        a0 = 16.0 - i / 16
        p = torch.exp(torch.tensor([8.0 * a0]) * scale - s1)
        err = float((p - p.to(bf).float()).abs())
        if err > best[0]:
            best = (err, a0)
    rng = np.random.default_rng(7)
    kc = torch.from_numpy(rng.standard_normal((1, cap, h, hd),
                                              dtype=np.float32))
    vc = torch.from_numpy(rng.standard_normal((1, cap, h, hd),
                                              dtype=np.float32))
    chunk = da.chunk4_for(cap)
    kc[:, 5], kc[:, chunk + 5] = 16.0, best[1]
    vc[:, 5], vc[:, chunk + 5] = -1.0, 1.0
    q = torch.zeros((1, h, hd))
    q[..., 0] = 8.0
    return q.to(bf), kc.to(bf), vc.to(bf), torch.tensor([cap + 37],
                                                        dtype=torch.int32)


def test_control_moves_the_boundary_case():
    q, kc, vc, off = boundary_case(750, H, HD)
    want = da.decode_attention4_plain(q, kc, vc, off, cap=750, context=750)
    assert torch.equal(split4(q, kc, vc, off, cap=750, context=750), want)
    ctl, _ = split4(q, kc, vc, off, cap=750, context=750, own_max=True)
    assert float((ctl - want).abs().max()) > 1e-4


def test_masked_chunks_are_masked():
    """The masked states above do leave a whole chunk without a valid slot
    before the first valid one and after the last (so the fold's skip is
    exercised on both sides), with two live chunks each."""
    for (_, cap, offsets, context), dead in zip(STATES[8:10], (0, 2)):
        r = offsets[0] % cap
        live = {j // 256 for j in range(cap) if (r - j) % cap < context}
        assert live == {0, 1, 2} - {dead}


def live_chunks4(offset: int, cap: int, context: int, chunk: int):
    """The kernel's ``live_chunks`` for K9 (last = offset, window =
    context, ceil(cap / chunk) chunks)."""
    nch = -(-cap // chunk)
    rmod = offset % cap
    span = min(context, offset + 1, cap)
    if span <= 0:
        return set()
    first = rmod - span + 1
    if span < cap and first >= 0:
        return set(range(first // chunk, rmod // chunk + 1))
    hi, lo = rmod // chunk, (first + cap) // chunk
    if span >= cap or lo <= hi:
        return set(range(nch))
    return set(range(hi + 1)) | set(range(lo, nch))


@pytest.mark.parametrize("cap", [750, 500, 300, 256, 200])
def test_live_chunks_match_the_slots(cap):
    """With ragged chunks too, a chunk is live exactly where one of its
    slots is valid, at every age across two wraps and several contexts."""
    chunk = da.chunk4_for(cap)
    for context in (1, 7, cap // 3, cap - 1, cap, cap + 5):
        for offset in sorted({0, 1, 2, 16, chunk - 1, chunk, chunk + 1,
                              cap // 3, cap - 1, cap, cap + 1, cap + 7,
                              2 * cap - 5, 2 * cap + 9, 3 * cap - 1}):
            r = offset % cap
            want = {j // chunk for j in range(cap)
                    if (r - j) % cap < context
                    and offset - (r - j) % cap >= 0}
            assert live_chunks4(offset, cap, context, chunk) == want, \
                (offset, context)


@pytest.mark.parametrize("b,cap,blocks,chunks", [
    (1, 750, 48, 3),      # the stt-1b at B = 1: 256 + 256 + 238
    (1, 500, 32, 2),      # the TTS frame: 256 + 244
    (8, 500, 256, 2),     # the TTS pool
    (1, 200, 16, 1),      # a ring of one chunk: no workspace
])
def test_k9_launch_plan(b, cap, blocks, chunks):
    h, hd = 16, 128
    chunk = da.chunk4_for(cap)
    plan = da.launch_plan(b, h, hd, cap, chunk, ragged=True)
    assert (plan.blocks, plan.chunks) == (blocks, chunks)
    heads = b * h
    if chunks == 1:
        assert (plan.sync_bytes, plan.parts_bytes) == (0, 0)
        return
    assert plan.sync_bytes == 8 * heads + 8 * heads * chunks
    assert plan.parts_bytes == 4 * heads * chunks * (hd + 4)


def test_k3_plan_still_rejects_a_ragged_chunk():
    with pytest.raises(ValueError, match="divide"):
        da.launch_plan(1, 16, 128, 750, 256)
    assert da.launch_plan(1, 16, 128, 750, 250).chunks == 3


def test_k9_launch_raises_without_a_toolchain():
    """No fallback: a K9 launch builds the kernels, and without nvcc that
    raises instead of running the plain version."""
    import shutil
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    q, kc, vc, off = _case([300], 750, hd=32)
    with pytest.raises(RuntimeError, match="nvcc"):
        da._launch4(q, kc, vc, off, 750, 750)
