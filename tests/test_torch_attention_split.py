"""K3's and K10's split form (``csrc/decode_attention.cu`` ``split_kernel``)
against the walk, on the CPU.

On the card K3 and K10 run one block per (session, head, chunk): each
block forms its chunk's p, sum p and p . v against the walk's running max
before the chunk (the seed's score and the maxima of the valid chunks
before it, the prefix max), and the last block of a (session, head) folds
the chunks' parts in the walk's order.  ``split_attention`` below is that
arithmetic in PyTorch: no running state crosses a chunk but the prefix
max, taken here with ``cummax`` (the max of exact values is the same in
any order).  It must equal the walk, the plain versions
``decode_attention_plain`` and ``decode_attention_mxu_plain``, bit for
bit; a control that rounds p against each chunk's own max (and rescales
the chunk's parts afterwards, as a split softmax usually does) must not.
Also ``launch_plan`` at every path's shapes and ``workspace``'s reuse.
"""

import numpy as np
import pytest
import torch

from moshi_tpu_torch.models.lm import LMConfig
from moshi_tpu_torch.nn import decode_attention as da
from moshi_tpu_torch.runtime.synth import tts_class_config

FP8 = torch.float8_e4m3fn
CAP, H, HD = 3000, 2, 16   # the 7B's ring at a narrow width


def split_attention(q, k_ring, v_ring, cur_k, cur_v, offset, *, cap: int,
                    context: int, chunk: int, mxu: bool = False,
                    own_max: bool = False) -> torch.Tensor:
    """K3's (or K10's, ``mxu``) split arithmetic for one layer's rings
    [B, cap, H, hd]; ``own_max``: the control."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    qf = q.float()
    s_cur = (cur_k.float() * qf).sum(-1) * scale                  # [B, H]
    qs, post = da._scores_query(qf, scale) if mxu else (qf, scale)
    last = offset.long() - 1
    r = torch.remainder(last, cap)
    scores, live = [], []
    for c0 in range(0, cap, chunk):
        k = k_ring[:, c0:c0 + chunk].float()                      # [B, C, H, hd]
        s = (k * qs[:, None]).sum(-1) * post                      # [B, C, H]
        j = torch.arange(c0, c0 + chunk)[None, :]
        delta = torch.where(j > r[:, None], r[:, None] - j + cap,
                            r[:, None] - j)
        valid = (delta < context - 1) & (last[:, None] - delta >= 0)
        scores.append(torch.where(valid[..., None], s,
                                  torch.full_like(s, da.NEG)))
        live.append(valid.any(1))                                 # [B]
    cmax = torch.stack([s.amax(1) for s in scores])               # [N, B, H]
    live = torch.stack(live)                                      # [N, B]
    # the prefix max: the seed's score, then each live chunk's max
    seen = torch.where(live[..., None], cmax,
                       torch.full_like(cmax, -float("inf")))
    prefix = torch.cummax(torch.cat([s_cur[None], seen[:-1]]), 0).values
    parts = []
    for c, s in enumerate(scores):                # each chunk on its own
        v = v_ring[:, c * chunk:(c + 1) * chunk].float()
        m_new = torch.maximum(prefix[c], cmax[c])
        corr = torch.exp(prefix[c] - m_new)
        if own_max:
            p = torch.exp(s - cmax[c][:, None])
            rescale = torch.exp(cmax[c] - m_new)
            psum = p.sum(dim=1) * rescale
            pv = (da._bf16_round(p)[..., None] * v).sum(dim=1) \
                * rescale[..., None]
        else:
            p = torch.exp(s - m_new[:, None])
            psum = p.sum(dim=1)
            pv = (da._bf16_round(p)[..., None] * v).sum(dim=1)
        parts.append((corr, psum, da._pv_round(pv) if mxu else pv))
    # the fold, in the walk's order; a chunk with no valid slot is skipped
    lsum = torch.ones_like(s_cur)
    acc = cur_v.float()
    for c, (corr, psum, pv) in enumerate(parts):
        keep = live[c][:, None]
        lsum = torch.where(keep, lsum * corr + psum, lsum)
        acc = torch.where(keep[..., None], acc * corr[..., None] + pv, acc)
    return acc / lsum[..., None]


def _case(offsets, *, dtype=torch.bfloat16, seed=0, cap=CAP, h=H, hd=HD):
    """q, cur_k, cur_v [B, H, hd] bf16, rings [B, cap, H, hd] (bf16 or fp8)
    and the offsets, drawn with numpy."""
    rng = np.random.default_rng(seed)
    b = len(offsets)

    def t(shape, to):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32)).to(to)

    cur = [t((b, h, hd), torch.bfloat16) for _ in range(3)]
    rings = [t((b, cap, h, hd), dtype) for _ in range(2)]
    return cur, rings, torch.tensor(offsets, dtype=torch.int32)


# (label, offsets, context, several chunks valid): fresh, partly filled and
# wrapped rings, leading chunks fully masked (a context shorter than the
# ring), mixed ages.  With one valid chunk the walk's running max before it
# is the seed's score alone, and the control differs only where the seed
# outscores the chunk, so it is held where several chunks are valid
STATES = [
    ("fresh", [1], CAP, False), ("fresh, 16 positions", [16], CAP, False),
    ("partly filled", [CAP // 3], CAP, True),
    ("at a chunk boundary", [251], CAP, True),
    ("wrapped", [CAP + 7], CAP, True),
    ("wrapped twice", [2 * CAP + 250], CAP, True),
    ("leading chunks masked", [CAP - 5], CAP // 3, True),
    ("masked chunks on both sides", [2 * CAP + 1500], CAP // 4, True),
    ("B = 4 at mixed ages", [3, CAP // 3, CAP + 17, 2 * CAP + 250], CAP,
     True),
]
# (kernel, chunk, ring dtype): K3 at chunk_for (250), K10 at chunk_for_mxu
# (200, bf16 rings only, as use_mxu_attn)
FORMS = [("K3", da.chunk_for(CAP), torch.bfloat16),
         ("K3 fp8", da.chunk_for(CAP), FP8),
         ("K10", da.chunk_for_mxu(CAP), torch.bfloat16)]


@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("state", STATES, ids=[s[0] for s in STATES])
def test_split_form_equals_the_walk(form, state):
    kernel, chunk, dtype = form
    _, offsets, context, several = state
    cur, rings, off = _case(offsets, dtype=dtype, seed=len(offsets) + chunk)
    mxu = kernel == "K10"
    walk = da.decode_attention_mxu_plain if mxu else da.decode_attention_plain
    kw = dict(cap=CAP, context=context, chunk=chunk)
    want = walk(cur[0], rings[0], rings[1], cur[1], cur[2], off, **kw)
    got = split_attention(cur[0], rings[0], rings[1], cur[1], cur[2], off,
                          mxu=mxu, **kw)
    assert torch.equal(got, want)
    if several:   # the control: p rounded against each chunk's own max
        ctl = split_attention(cur[0], rings[0], rings[1], cur[1], cur[2],
                              off, mxu=mxu, own_max=True, **kw)
        assert not torch.equal(ctl, want)


def test_leading_masked_chunks_are_masked():
    """The masked states above do leave whole chunks without a valid slot
    before the first valid one (so the fold's skip is exercised)."""
    for _, offsets, context, _ in STATES[6:8]:
        last = offsets[0] - 1
        r = last % CAP
        valid = [(r - j) % CAP < context - 1 for j in range(CAP)]
        first = valid.index(True)
        assert first >= 250 and not any(valid[:250])


def live_chunks(offset: int, cap: int, context: int, chunk: int):
    """The kernel's ``live_chunks``: the chunks with a valid slot, from the
    offset alone (the valid slots are the span = min(context - 1, offset,
    cap) slots that end at (offset - 1) mod cap, cyclically)."""
    last, nch = offset - 1, cap // chunk
    rmod = last % cap
    span = min(context - 1, last + 1, cap)
    if span <= 0:
        return set()
    first = rmod - span + 1
    if span < cap and first >= 0:
        return set(range(first // chunk, rmod // chunk + 1))
    hi, lo = rmod // chunk, (first + cap) // chunk
    if span >= cap or lo <= hi:
        return set(range(nch))
    return set(range(hi + 1)) | set(range(lo, nch))


@pytest.mark.parametrize("cap,chunk", [(3000, 250), (3000, 200), (48, 16),
                                       (8, 8), (500, 250)])
def test_live_chunks_match_the_slots(cap, chunk):
    """A chunk is live exactly where one of its slots is valid (the walk's
    vote), at every age across two wraps and several contexts."""
    for context in (2, 7, cap // 3, cap - 1, cap, cap + 5):
        for offset in sorted({0, 1, 2, 16, chunk - 1, chunk, chunk + 1,
                              cap // 3, cap - 1, cap, cap + 1, cap + 7,
                              2 * cap - chunk, 2 * cap + 250, 3 * cap - 1}):
            last = offset - 1
            r = last % cap
            valid = [((r - j) % cap < context - 1) and last - (r - j) % cap
                     >= 0 for j in range(cap)]
            want = {j // chunk for j in range(cap) if valid[j]}
            assert live_chunks(offset, cap, context, chunk) == want, \
                (offset, context)


def _paths():
    """(path, B, H, hd, cap, chunk) of every K3 and K10 call the port
    makes: the 7B's temporal and depformer rings at B = 1 and in the B = 8
    pool, K10 on both, and the TTS class's depformer ring (its temporal
    stack takes K9)."""
    cfg = LMConfig()
    _, tts = tts_class_config()
    out = []
    for b in (1, 8):
        for tc, where in ((cfg.transformer, "temporal"),
                          (cfg.depformer, "depformer")):
            m = tc.mha
            out.append((f"K3 {where} B={b}", b, m.num_heads, m.head_dim,
                        m.cap, da.chunk_for(m.cap)))
            out.append((f"K10 {where} B={b}", b, m.num_heads, m.head_dim,
                        m.cap, da.chunk_for_mxu(m.cap)))
        m = tts.depformer.mha
        out.append((f"K3 TTS depformer B={b}", b, m.num_heads, m.head_dim,
                    m.cap, da.chunk_for(m.cap)))
    return out


@pytest.mark.parametrize("path", _paths(), ids=lambda p: p[0])
def test_launch_plan_at_every_path(path):
    name, b, h, hd, cap, chunk = path
    plan = da.launch_plan(b, h, hd, cap, chunk)
    assert plan.chunks * chunk == cap
    assert plan.blocks == b * h * plan.chunks
    if plan.chunks == 1:      # the depformer rings: no workspace
        assert (plan.sync_bytes, plan.parts_bytes) == (0, 0)
        assert "depformer" in name
        return
    heads = b * h
    assert plan.sync_bytes == 4 * heads * 2 + 8 * heads * plan.chunks
    assert plan.parts_bytes == 4 * heads * plan.chunks * (hd + 4)
    assert plan.parts_bytes <= 2.1e6          # K10 at B = 8: 2.03 MB


def test_launch_plan_7b_grid():
    """The 7B temporal ring: 384 blocks for K3 (12 chunks of 250) and 480
    for K10 (15 of 200) at B = 1; eight times that at B = 8."""
    assert da.launch_plan(1, 32, 128, 3000, 250)[:2] == (384, 12)
    assert da.launch_plan(1, 32, 128, 3000, 200)[:2] == (480, 15)
    assert da.launch_plan(8, 32, 128, 3000, 250).blocks == 3072
    assert da.launch_plan(8, 32, 128, 3000, 200).blocks == 3840
    with pytest.raises(ValueError, match="divide"):
        da.launch_plan(1, 32, 128, 3000, 256)


def test_workspace_is_reused_and_grows(monkeypatch):
    monkeypatch.setattr(da, "_WORKSPACE", {})
    sync, parts = da.workspace("cpu", 64, 1000)
    assert sync.dtype == torch.uint8 and not sync.any()
    assert (sync.numel(), parts.numel()) == (64, 1000)
    again = da.workspace("cpu", 32, 500)      # smaller: the same tensors
    assert again[0] is sync and again[1] is parts
    grown = da.workspace("cpu", 128, 800)     # more sync: a new zeroed one
    assert grown[0] is not sync and grown[0].numel() == 128
    assert not grown[0].any() and grown[1] is parts


def test_split_launch_raises_without_a_toolchain():
    """No fallback: a K3 launch of several chunks builds the kernels, and
    without nvcc that raises instead of running the plain version."""
    import shutil
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    cur, rings, off = _case([20], cap=48, hd=32)
    with pytest.raises(RuntimeError, match="nvcc"):
        da._launch(cur[0], rings[0][None], rings[1][None], cur[1], cur[2],
                   off, 0, 48, 48, 16)
