"""fp8 KV rings (``LMConfig.kv_dtype = "float8_e4m3fn"``): the port against
the JAX package, on the CPU.

* The port's fp8 cast (``nn/ring.py`` ``fp8_cast``) against
  ``jnp.astype(float8_e4m3fn)`` bit for bit: every tie between two e4m3
  values and its f32 neighbours, subnormals, 448, 464, 465, inf and NaN,
  from f32 and from bf16.
* K4's and K11's plain versions against the Pallas ``ring_write_stacked``
  and ``ring_write`` in interpret mode on fp8 rings, from f32 and bf16
  rows: bit for bit, NaN in the same places.
* K3's and K9's plain versions against the Pallas kernels in interpret
  mode on fp8 rings, at their bf16 tests' limits.
* A 2-layer ``lm_gen_step`` (the q4_k stacked decode: K3, K4) and a
  2-layer STT step (the generic stack: K9, K11) with fp8 rings against
  JAX over frames that wrap the ring; the rings compared by the flip rule
  (``_flips``), the seed of K3 checked against the old fp8-rounded one.
* ``gen_state_from_numpy`` on a JAX fp8 state, ``kv_bytes_per_session``
  and ``suggest_sessions`` at fp8, and the pool's slot reset and the
  pipelines' ``init_state`` / ``step`` on fp8 rings.  (K13 on fp8 flat
  rings: ``test_torch_temporal_fp8.py``.)

Inputs are seeded numpy draws handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
import test_torch_lm as tl
import test_torch_stt as ts
from moshi_tpu.nn.pallas_attention import \
    decode_attention as jax_decode_attention
from moshi_tpu.nn.pallas_attention import \
    decode_attention_stacked as jax_decode_attention_stacked
from moshi_tpu.nn.pallas_ring import ring_write as jax_ring_write4
from moshi_tpu.nn.pallas_ring import ring_write_stacked as jax_ring_write
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn import decode_attention as port_da
from moshi_tpu_torch.nn import ring as port_ring
from moshi_tpu_torch.runtime import memory
from moshi_tpu_torch.runtime.convert import (gen_state_from_numpy,
                                             params_from_numpy)

FP8 = "float8_e4m3fn"
_NP_FP8 = ml_dtypes.float8_e4m3fn
# K3 / K9 on fp8 rings: the plain versions widen the ring exactly, so the
# arithmetic and its limits are their bf16 tests' (test_torch_attention)
_TOL_ATTN, _TOL_ATTN4 = 1e-5, 1e-6
# The flip rule: a ring element where the port and JAX differ must be the
# other e4m3 neighbour of the port's f32 value, that value within this
# share of its magnitude from the midpoint of the two.  The packages' rows
# differ by their f32 sum order and, in the q4_k frame, by a flipped int8
# activation rounding (transformer_out up to 2e-3 apart:
# test_torch_lm._RTOL).  Readings: no flip in the 2-layer q4_k frames'
# 8192 written k elements nor the STT's 6144 (nor in v); transformer_out
# 1.9e-5 and the logits 7.7e-6 from JAX's (q4_k), 1.9e-7 and 2.3e-7 (STT).
# A double rounding through bf16 (f32 -> bf16 -> fp8) flips values up to
# one bf16 half-step (2^-9 = 2e-3) from a tie: 20 to 35 of the same
# elements (3.3e-3 to 4.3e-3), so flips are held to a share of 1e-3.
_TIE = 2e-3
_FLIPS = 1e-3


def _f8_bits(a):
    return np.asarray(a).view(np.uint8)


def _t8(a):
    """A numpy float8_e4m3fn array as a torch fp8 tensor, bit for bit."""
    return torch.from_numpy(np.array(np.asarray(a).view(np.uint8))).view(
        torch.float8_e4m3fn)


def _tbits(t):
    return t.view(torch.uint8).numpy()


def _tbf16(a):
    """A bf16 JAX array as a torch tensor, bit for bit (XLA's f32 -> bf16
    drops a NaN's sign; PyTorch's keeps it)."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _e4m3_values():
    """Every finite non-negative e4m3 value, ascending."""
    return np.arange(0x7F, dtype=np.uint8).view(_NP_FP8).astype(np.float32)


def probe_values():
    """f32 values at every e4m3 tie (the midpoint of two neighbours, and
    the f32 values on either side of it), at e4m3 values, subnormals,
    448, 464 and its neighbours, 465, 480, 1e6, inf and NaN, both signs."""
    v = _e4m3_values()
    mid = ((v[:-1] + v[1:]) / 2).astype(np.float32)
    up = np.nextafter(mid, np.float32(np.inf))
    down = np.nextafter(mid, np.float32(0))
    edge = np.array([448, 449, 463.99, 464, np.nextafter(np.float32(464),
                                                         np.float32(1e9)),
                     465, 480, 1e6, np.inf, np.nan, 2.0 ** -9, 2.0 ** -10,
                     3 * 2.0 ** -11, 1e-30, 0.0], np.float32)
    pos = np.concatenate([v, mid, up, down, edge])
    return np.concatenate([pos, -pos]).astype(np.float32)


@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_fp8_cast_matches_jax_bit_for_bit(src):
    x = probe_values()
    rng = np.random.default_rng(0)
    x = np.concatenate([x, rng.normal(0, 30, 4096).astype(np.float32)])
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if src == "bf16":
        jx = jx.astype(jnp.bfloat16)
        tx = _tbf16(jx)
    ref = _f8_bits(jx.astype(jnp.float8_e4m3fn))
    got = _tbits(port_ring.fp8_cast(tx))
    np.testing.assert_array_equal(got, ref)
    # NaN above 464 (and for NaN), 448 at 464 exactly, both signs
    if src == "f32":
        big = np.abs(x) > 464
        assert ((got[big] & 0x7F) == 0x7F).all()
        assert (got[np.abs(x) == 464] & 0x7F == 0x7E).all()
    # PyTorch's own cast saturates instead, so it differs exactly there
    sat = _tbits(tx.to(torch.float8_e4m3fn))
    differ = sat != ref
    xf = np.asarray(jnp.asarray(jx, jnp.float32))
    assert differ.any()
    np.testing.assert_array_equal(differ, np.abs(xf) > 464)


def _probe_rows(shape, rng, dtype):
    """Rows of ``shape`` holding the probe values (tiled) and random ones,
    in f32 or bf16 on both sides."""
    x = probe_values()
    n = int(np.prod(shape))
    assert n >= x.size
    x = np.concatenate([x, rng.normal(0, 8, n - x.size)])
    x = rng.permutation(x).astype(np.float32).reshape(shape)
    if dtype == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        return jx, _tbf16(jx)
    return jnp.asarray(x), torch.from_numpy(x)


def _fp8_rings(rng, shape, n=2):
    x = rng.normal(0, 1, (n,) + shape).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))


@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_ring_write_plain_fp8_matches_pallas(src):
    """K4 on fp8 rings: [L, B, cap, H, hd] with every session at its own
    slot, rows carrying the probe values."""
    rng = np.random.default_rng(3)
    nl, b, cap, h, hd = 3, 2, 8, 4, 64
    rings = _fp8_rings(rng, (nl, b, cap, h, hd))
    jks, tks = _probe_rows((nl, b, h, hd), rng, src)
    jvs, tvs = _probe_rows((nl, b, h, hd), rng, src)
    slot = np.array([5, 0], np.int32)
    kr, vr = jax_ring_write(jnp.asarray(rings[0]), jnp.asarray(rings[1]),
                            jks, jvs, jnp.asarray(slot), interpret=True)
    tk, tv = _t8(rings[0]), _t8(rings[1])
    port_ring.ring_write_stacked(tk, tv, tks, tvs, torch.from_numpy(slot))
    np.testing.assert_array_equal(_tbits(tk), _f8_bits(kr))
    np.testing.assert_array_equal(_tbits(tv), _f8_bits(vr))
    assert ((_tbits(tk) & 0x7F) == 0x7F).any()        # NaN was written


@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_ring_write4_plain_fp8_matches_pallas(src):
    """K11 on an fp8 ring [B, cap, H, hd]."""
    rng = np.random.default_rng(4)
    b, cap, h, hd = 3, 8, 4, 128
    ring = _fp8_rings(rng, (b, cap, h, hd), n=1)[0]
    jv, tv = _probe_rows((b, h, hd), rng, src)
    slot = np.array([7, 0, 3], np.int32)
    ref = jax_ring_write4(jnp.asarray(ring), jv, jnp.asarray(slot),
                          interpret=True)
    got = port_ring.ring_write(_t8(ring), tv, torch.from_numpy(slot))
    np.testing.assert_array_equal(_tbits(got), _f8_bits(ref))
    assert ((_tbits(got) & 0x7F) == 0x7F).any()       # NaN was written


def _shifted(n, dtype, shift):
    """A contiguous tensor of ``n`` values whose data starts ``shift``
    elements into its storage."""
    return torch.zeros(n + shift, dtype=dtype)[shift:]


@pytest.mark.parametrize("case", ["aligned", "row of 24", "ring base",
                                  "rows base", "bf16 ring, f32 rows",
                                  "bf16 ring, f16 rows"])
def test_fp8_ring_write_operands_checked(case):
    """The kernels' wrappers raise where the fp8 write's 16-value vectors
    do not fit (a row not a multiple of 16 values, a base not 16-byte
    aligned) and on rows the kernel does not convert (f16); a bf16 ring
    takes f32 rows, converted in the write."""
    row = 24 if case == "row of 24" else 32
    ring_dt = torch.bfloat16 if case.startswith("bf16") else port_ring.FP8
    row_dt = torch.float16 if case.endswith("f16 rows") else torch.float32
    ring = _shifted(4 * row, ring_dt, 1 if case == "ring base" else 0)
    rows = _shifted(row, row_dt, 1 if case == "rows base" else 0)
    check = lambda: port_ring._check_operands(  # noqa: E731
        torch.device("cpu"), (("cache", ring),), (("values", rows),), row)
    if case == "aligned":
        assert check() == (True, False, [row])
    elif case == "bf16 ring, f32 rows":
        assert check() == (False, False, [row])
    else:
        with pytest.raises(ValueError):
            check()


def test_ring_index_copy_converts_by_the_rule():
    """``ring_index_copy_`` (the T > 1 insert, the pool's slot reset): an
    fp8 ring gets f32 rows by ``fp8_cast`` and fp8 rows bit for bit (NaN
    included), a bf16 ring what ``index_copy_`` gives."""
    rng = np.random.default_rng(11)
    _, x = _probe_rows((3, 512), rng, "f32")
    idx = torch.tensor([4, 0, 2])
    ring = torch.zeros((5, 512), dtype=port_ring.FP8)
    port_ring.ring_index_copy_(ring, 0, idx, x)
    want = port_ring.fp8_cast(x).view(torch.uint8)
    assert torch.equal(ring.view(torch.uint8)[idx], want)
    again = torch.zeros_like(ring)
    port_ring.ring_index_copy_(again, 0, idx, ring[idx])
    assert torch.equal(again.view(torch.uint8), ring.view(torch.uint8))
    assert ((want & 0x7F) == 0x7F).any()              # NaN went through
    bf = torch.zeros((5, 512), dtype=torch.bfloat16)
    port_ring.ring_index_copy_(bf, 0, idx, x)
    want = torch.zeros_like(bf).index_copy_(0, idx, x.to(torch.bfloat16))
    assert torch.equal(bf.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("cap,context,offsets", [
    (300, 300, (0, 5)),
    (300, 300, (300, 301)),
    (300, 200, (450, 1000)),
])
def test_decode_attention_plain_fp8_matches_pallas(cap, context, offsets):
    """K3 on fp8 rings: q, cur_k and cur_v bf16; the ring widened
    exactly."""
    rng = np.random.default_rng(cap + offsets[1])
    h, hd, nl = 4, 32, 2
    rings = _fp8_rings(rng, (nl, len(offsets), cap, h, hd))
    cur = rng.normal(0, 1, (3, len(offsets), h, hd)).astype(np.float32)
    jcur = jnp.asarray(cur, jnp.bfloat16)
    tcur = torch.from_numpy(cur).to(torch.bfloat16)
    off = np.asarray(offsets, np.int32)
    ref = np.asarray(jax_decode_attention_stacked(
        jcur[0], jnp.asarray(rings[0]), jnp.asarray(rings[1]), jcur[1],
        jcur[2], jnp.asarray(off), jnp.int32(1), cap=cap, context=context,
        interpret=True))
    got = port_da.decode_attention_stacked(
        tcur[0], _t8(rings[0]), _t8(rings[1]), tcur[1], tcur[2],
        torch.from_numpy(off), 1, cap=cap, context=context)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_TOL_ATTN)


@pytest.mark.parametrize("cap,context,offsets", [
    (750, 750, (0, 700)),         # a padded tail chunk
    (256, 256, (255, 900)),
    (32, 24, (3, 40)),
])
def test_decode_attention4_plain_fp8_matches_pallas(cap, context, offsets):
    """K9 on fp8 rings [B, cap, H, hd], read after the write; q f32."""
    rng = np.random.default_rng(cap + offsets[1] + 1)
    h, hd = 4, 32
    rings = _fp8_rings(rng, (len(offsets), cap, h, hd))
    q = rng.normal(0, 1, (len(offsets), h, hd)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(rings[0]), jnp.asarray(rings[1]),
        jnp.asarray(off), cap=cap, context=context, interpret=True))
    got = port_da.decode_attention(
        torch.from_numpy(q), _t8(rings[0]), _t8(rings[1]),
        torch.from_numpy(off), cap=cap, context=context)
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=_TOL_ATTN4 * scale)


# ---------------------------------------------------------------------------
# frames against JAX
# ---------------------------------------------------------------------------

def _flips(port_bits, jax_bits, values, tie=_TIE):
    """(flips, elements, worst): where the two rings differ, the port's
    f32 ``values`` must lie between the two e4m3 values within ``tie`` of
    their midpoint (relative), so that each difference is a rounding that
    flipped at a tie.  Raises where one is not."""
    diff = port_bits != jax_bits
    if not diff.any():
        return 0, port_bits.size, 0.0
    a = port_bits[diff].view(_NP_FP8).astype(np.float32)
    j = jax_bits[diff].view(_NP_FP8).astype(np.float32)
    x = values[diff]
    between = (x - a) * (x - j) <= 0
    dist = np.abs(x - (a + j) / 2) / np.abs(x)
    assert between.all() and np.all(dist <= tie), (
        x[~between | (dist > tie)][:8], a[:8], j[:8])
    return int(diff.sum()), port_bits.size, float(dist.max())


class _RowRecorder:
    """The f32 rows the port's fp8 ring writes take, replayed into an f32
    shadow of each ring (the last write of each slot wins, as in the
    ring): the stacked write's [L, B, H, hd] rows, or the generic stack's
    K11 calls (k, then v, per layer)."""

    def __init__(self, shape):
        self.shadow = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
        self.calls = 0
        self.dtypes = set()

    def stacked(self, fn):
        def rec(k_stack, v_stack, ks, vs, slot):
            if k_stack.dtype == port_ring.FP8:
                self.dtypes.add(ks.dtype)
                bi = torch.arange(ks.shape[1])
                s = torch.remainder(slot.long(), k_stack.shape[2])
                self.shadow["k"][:, bi, s] = ks.float()
                self.shadow["v"][:, bi, s] = vs.float()
            return fn(k_stack, v_stack, ks, vs, slot)
        return rec

    def generic(self, fn):
        def rec(cache, values, slot):
            if cache.dtype == port_ring.FP8:
                self.dtypes.add(values.dtype)
                nl = self.shadow["k"].shape[0]
                layer, name = (self.calls // 2) % nl, "kv"[self.calls % 2]
                self.calls += 1
                bi = torch.arange(values.shape[0])
                s = torch.remainder(slot.long(), cache.shape[1])
                self.shadow[name][layer, bi, s] = values.float()
            return fn(cache, values, slot)
        return rec


def _jax_frames(cfg, params, other, form=None):
    """JAX's frames at temp 0 (jitted, Pallas in interpret mode): h, the
    text logits, the outputs, and the final KV rings as numpy."""
    logged = []
    orig_sample = jax_lm.sample_token

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    def step(p, s, o):
        text, h, s = jax_lm.lm_text_step(cfg, p, s, other_audio=o,
                                         temp_text=0.0)
        out, s = jax_lm.lm_audio_step(cfg, p, s, text, h, temp=0.0)
        return out, s, h

    import moshi_tpu.nn.pallas_ring as jax_pallas_ring
    orig_rw = jax_pallas_ring.ring_write
    row_dtypes = set()

    def ring_write(cache, values, slot, **kw):      # traced: dtypes only
        row_dtypes.add(str(values.dtype))
        return orig_rw(cache, values, slot, **kw)

    frames = []
    old = os.environ.get("MOSHI_TPU_FUSE_MID")
    if form is not None:
        os.environ["MOSHI_TPU_FUSE_MID"] = form
    jax_lm.sample_token = sample
    jax_pallas_ring.ring_write = ring_write
    enable_pallas(True)
    try:
        with pallas_interpret():
            jstep = jax.jit(step)
            state = jax_lm.init_gen_state(cfg, 1, jax.random.PRNGKey(5))
            for o in other:
                out, state, h = jstep(params, state, jnp.asarray(o))
                frames.append({"out": {k: np.asarray(v)
                                       for k, v in out.items()},
                               "h": np.asarray(h)})
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
        jax_pallas_ring.ring_write = orig_rw
        if form is not None:
            if old is None:
                os.environ.pop("MOSHI_TPU_FUSE_MID", None)
            else:
                os.environ["MOSHI_TPU_FUSE_MID"] = old
    per = len(logged) // len(frames)
    for f, fr in enumerate(frames):
        fr["logits"] = logged[f * per]
    rings = {k: np.asarray(state["transformer"][k]) for k in ("k", "v")}
    return frames, rings, state, row_dtypes


def _port_frames(cfg, params, other, recorder=None, seeds=None):
    """The port's frames at temp 0 with h and the text logits taken on the
    way; the rows of the fp8 ring writes go to ``recorder``, K3's seeds
    (cur_k) to ``seeds``.  Returns (frames, final state)."""
    frames, taps = [], {}
    saved = {(port_lm, "temporal_forward"): port_lm.temporal_forward,
             (port_lm, "sample_token"): port_lm.sample_token,
             (port_ring, "ring_write_plain"): port_ring.ring_write_plain,
             (port_ring, "ring_write4_plain"): port_ring.ring_write4_plain,
             (port_da, "decode_attention_plain"):
             port_da.decode_attention_plain}

    def tf(*a, **kw):
        h, logits, kv = saved[(port_lm, "temporal_forward")](*a, **kw)
        taps["h"] = h[:, -1].numpy().copy()
        return h, logits, kv

    def sample(logits, *a, **kw):
        taps.setdefault("logits", logits.numpy().copy())
        return saved[(port_lm, "sample_token")](logits, *a, **kw)

    def seed_spy(q, k_ring, v_ring, cur_k, cur_v, *a, **kw):
        if seeds is not None and k_ring.dtype == port_ring.FP8:
            seeds.append(cur_k.clone())
        return saved[(port_da, "decode_attention_plain")](
            q, k_ring, v_ring, cur_k, cur_v, *a, **kw)

    port_lm.temporal_forward, port_lm.sample_token = tf, sample
    port_da.decode_attention_plain = seed_spy
    if recorder is not None:
        port_ring.ring_write_plain = recorder.stacked(
            saved[(port_ring, "ring_write_plain")])
        port_ring.ring_write4_plain = recorder.generic(
            saved[(port_ring, "ring_write4_plain")])
    try:
        state = port_lm.init_gen_state(cfg, 1, device="cpu")
        for o in other:
            taps.clear()
            out, state = port_lm.lm_gen_step(
                cfg, params, state, other_audio=torch.from_numpy(o),
                temp=0.0, temp_text=0.0)
            frames.append({"out": {k: v.numpy() for k, v in out.items()},
                           **taps})
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return frames, state


def _compared(ref, got, rtol):
    """Frames before the first text token that differs where JAX's
    top-1/top-2 gap is within ``rtol``."""
    for f, (r, g) in enumerate(zip(ref, got)):
        diff = r["out"]["sampled_text"] != g["out"]["sampled_text"]
        if np.any(diff & (tl._gap(r["logits"]) <= rtol)):
            return f
    return len(ref)


_RUNS = {}


def _lm_run():
    """The 2-layer q4_k LM (test_torch_lm's configuration, 16-slot ring)
    with fp8 rings over 24 frames in both packages (fused form)."""
    if "lm" not in _RUNS:
        kw = dict(tl._KW, kv_dtype=FP8)
        cfg = jax_lm.LMConfig(**kw)
        params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
        rng = np.random.default_rng(7)
        other = rng.integers(0, cfg.card, (tl._FRAMES, 1, cfg.n_q - cfg.dep_q),
                             dtype=np.int32)
        ref, rings, jstate, _ = _jax_frames(cfg, params, other, form="1")
        pcfg = port_lm.LMConfig(**kw)
        pparams = params_from_numpy(tl.export_numpy(params), device="cpu")
        rec = _RowRecorder((pcfg.num_layers, 1, pcfg.context, pcfg.num_heads,
                            pcfg.dim // pcfg.num_heads))
        seeds = []
        old = os.environ.get("MOSHI_TPU_FUSE_MID")
        os.environ["MOSHI_TPU_FUSE_MID"] = "1"
        try:
            got, state = _port_frames(pcfg, pparams, other, rec, seeds)
        finally:
            if old is None:
                os.environ.pop("MOSHI_TPU_FUSE_MID", None)
            else:
                os.environ["MOSHI_TPU_FUSE_MID"] = old
        _RUNS["lm"] = dict(ref=ref, got=got, rings=rings, state=state,
                           rec=rec, seeds=seeds, jstate=jstate, cfg=pcfg)
    return _RUNS["lm"]


def _stt_run():
    """The tiny dense STT (test_torch_stt's configuration, 24-slot ring)
    with fp8 rings over 32 frames in both packages."""
    if "stt" not in _RUNS:
        kw = dict(ts._KW, kv_dtype=FP8)
        cfg = jax_lm.LMConfig(**kw)
        params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg)
        rng = np.random.default_rng(7)
        other = rng.integers(0, cfg.card, (ts._FRAMES, 1, cfg.n_q),
                             dtype=np.int32)
        ref, rings, _, jax_rows = _jax_frames(cfg, params, other)
        pcfg = port_lm.LMConfig(**kw)
        pparams = params_from_numpy(ts._np(params), device="cpu")
        rec = _RowRecorder((pcfg.num_layers, 1, pcfg.context, pcfg.num_heads,
                            pcfg.dim // pcfg.num_heads))
        got, state = _port_frames(pcfg, pparams, other, rec)
        _RUNS["stt"] = dict(ref=ref, got=got, rings=rings, state=state,
                            rec=rec, cfg=pcfg, jax_rows=jax_rows)
    return _RUNS["stt"]


@pytest.mark.parametrize("which,rtol", [("lm", tl._RTOL), ("stt", ts._RTOL)])
def test_fp8_frames_match_jax(which, rtol):
    """transformer_out and the text logits at the bf16 tests' limits, the
    text tokens equal where decided, over frames that wrap the ring."""
    r = _lm_run() if which == "lm" else _stt_run()
    ref, got = r["ref"], r["got"]
    n = _compared(ref, got, rtol)
    assert n == len(ref), f"token streams diverged at frame {n}"
    assert len(ref) > r["cfg"].context          # the ring wrapped
    for f in range(n):
        assert tl._rel_err(got[f]["h"], ref[f]["h"]) < rtol, f
        assert tl._rel_err(got[f]["logits"], ref[f]["logits"]) < rtol, f
        decided = tl._gap(ref[f]["logits"]) > rtol
        np.testing.assert_array_equal(
            got[f]["out"]["sampled_text"][decided],
            ref[f]["out"]["sampled_text"][decided])


@pytest.mark.parametrize("which", ["lm", "stt"])
def test_fp8_rings_match_jax_by_the_flip_rule(which):
    """The port's final fp8 rings are its f32 rows cast by the rule, bit
    for bit, and they equal JAX's but for flips at ties."""
    r = _lm_run() if which == "lm" else _stt_run()
    for name in ("k", "v"):
        ring = r["state"]["transformer"][name]
        assert ring.dtype == torch.float8_e4m3fn
        shadow = r["rec"].shadow[name]
        np.testing.assert_array_equal(_tbits(ring),
                                      _tbits(port_ring.fp8_cast(shadow)))
        flips, n, _ = _flips(_tbits(ring), _f8_bits(r["rings"][name]),
                             shadow.numpy())
        assert flips <= n * _FLIPS, (flips, n)
        # the control: the rows rounded to bf16 before the cast flip more
        # elements than the limit lets through
        twice = _tbits(port_ring.fp8_cast(shadow.to(torch.bfloat16)))
        assert (twice != _tbits(ring)).sum() > n * _FLIPS


def test_fp8_rows_reach_the_write_in_the_reference_dtype():
    """The rows K4 and K11 convert are f32 in both stacks, the dtype the
    JAX package casts to fp8 there (its generic stack's ``linear``
    returns the f32 stream's dtype; its stacked decode casts its f32 rows
    before the write)."""
    assert _lm_run()["rec"].dtypes == {torch.float32}
    r = _stt_run()
    assert r["rec"].dtypes == {torch.float32}
    assert r["jax_rows"] == {"float32"}


def test_fp8_seed_is_the_bf16_row():
    """K3's seed is the current row rounded to bf16 (the JAX package's
    k_new.astype(bf16)), not the fp8-rounded ring row: most seed values
    are not e4m3 values.  (Seeding from the ring's dtype, as the port did
    before fp8 rings were ported, fails here.)"""
    seeds = _lm_run()["seeds"]
    assert seeds and all(s.dtype == torch.bfloat16 for s in seeds)
    s = torch.cat([x.flatten() for x in seeds]).float()
    as_fp8 = port_ring.fp8_cast(s).float()
    assert (as_fp8 != s).float().mean() > 0.5


def test_gen_state_from_numpy_carries_fp8():
    """The JAX state after the fp8 frames crosses the bridge bit for bit."""
    r = _lm_run()
    j = r["jstate"]
    state = gen_state_from_numpy(
        {"transformer": {n: np.asarray(j["transformer"][n])
                         for n in ("k", "v")},
         "cache": np.asarray(j["cache"]), "offset": np.asarray(j["offset"])},
        device="cpu")
    for name in ("k", "v"):
        assert state["transformer"][name].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_tbits(state["transformer"][name]),
                                      _f8_bits(r["rings"][name]))
    assert int(state["offset"][0]) == len(r["ref"])
    np.testing.assert_array_equal(state["cache"].numpy(),
                                  np.asarray(j["cache"]))


def test_kv_bytes_halve_and_sessions_double(monkeypatch):
    monkeypatch.setattr(memory, "hbm_bytes", lambda device=None: 80 * 10 ** 9)
    cfg = port_lm.LMConfig()
    cfg8 = port_lm.LMConfig(kv_dtype=FP8)
    assert cfg8.transformer.kv_dtype == torch.float8_e4m3fn
    assert cfg8.depformer.kv_dtype == torch.bfloat16
    per = memory.kv_bytes_per_session(cfg)
    assert memory.kv_bytes_per_session(cfg8) * 2 == per == \
        32 * 3000 * 32 * 128 * 2 * 2
    w = int(4.3e9)
    n = memory.suggest_sessions(cfg, w)
    assert n >= 3
    assert memory.suggest_sessions(cfg8, w) >= 2 * n - 2
    with pytest.raises(ValueError, match="kv_dtype"):
        port_lm.LMConfig(kv_dtype="float16")


def test_pool_resets_fp8_slots_and_pipelines_step_on_fp8():
    """A B = 3 ``SessionPool`` (``STSPipeline.step``) on fp8 rings: a
    re-attached slot's rings are zero again (the reset copies fp8 rows
    through their bytes) while a live neighbour's keep their values; then
    ``STTPipeline`` steps on fp8 rings."""
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.nn.seanet import SEANetConfig
    from moshi_tpu_torch.runtime.pipeline import STSPipeline, STTPipeline
    from moshi_tpu_torch.runtime.serving import SessionPool
    from moshi_tpu_torch.runtime.synth import (synth_lm_params,
                                               synth_mimi_params)
    from tests.test_torch_pipeline import _LM, _MIMI, _SEANET
    cfg = port_lm.LMConfig(**dict(_LM, kv_dtype=FP8))
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    pipe = STSPipeline(mimi, cfg, temp=0.8, temp_text=0.7, top_k=8,
                       top_k_text=8, mimi_dtype=torch.float32, device="cpu")
    pool = SessionPool(pipe, synth_mimi_params(mimi.cfg, device="cpu",
                                               seed=0),
                       synth_lm_params(cfg, "q4_k", device="cpu", seed=1),
                       batch=3)
    rng = np.random.default_rng(2)
    fs = pipe.frame_samples
    pool.attach("x")
    pool.attach("y")
    for _ in range(3):
        outs = pool.tick({s: rng.normal(size=fs).astype(np.float32) * 0.1
                          for s in ("x", "y")})
    assert all(np.isfinite(o["audio_out"]).all() for o in outs.values())
    rings = pool.state["lm"]["transformer"]
    assert rings["k"].dtype == torch.float8_e4m3fn
    ix, iy = pool._by_session["x"], pool._by_session["y"]
    before = _tbits(rings["k"][:, ix]).copy()
    assert before.any() and _tbits(rings["v"][:, iy]).any()
    pool.detach("y")
    pool.attach("z")
    assert pool._by_session["z"] == iy
    for name in ("k", "v"):
        assert not _tbits(rings[name][:, iy]).any()
    np.testing.assert_array_equal(_tbits(rings["k"][:, ix]), before)

    stt = port_lm.LMConfig(**dict(ts._KW, kv_dtype=FP8))
    smimi = MimiModel(MimiConfig(seanet=SEANetConfig(**ts._SEANET),
                                 **ts._MIMI))
    spipe = STTPipeline(smimi, stt, mimi_dtype=torch.float32, device="cpu")
    sparams = synth_lm_params(stt, None, device="cpu", seed=3)
    mparams = synth_mimi_params(smimi.cfg, device="cpu", seed=4)
    state = spipe.init_state(1, seed=5)
    assert state["lm"]["transformer"]["k"].dtype == torch.float8_e4m3fn
    for _ in range(3):
        out, state = spipe.step(mparams, sparams, state,
                                rng.normal(size=(1, spipe.frame_samples))
                                .astype(np.float32) * 0.1)
    assert 0 <= int(out["text"][0]) < stt.text_card
    assert 0.0 <= float(out["vad"][0]) <= 1.0
    assert _tbits(state["lm"]["transformer"]["k"]).any()


@pytest.mark.parametrize("t,offset", [(3, 5), (3, 7), (20, 2)])
def test_streaming_mha_t_gt_1_on_fp8_rings_matches_jax(t, offset):
    """The generic step at T > 1 (Mimi's T = 2 form): the positions go
    into fp8 rings through the cast rule (the scatter path; T > cap
    wraps, the last write winning) and the einsum branch widens the rings
    to bf16, as the JAX package's ``.astype(bf16)``.  Rings bit for bit;
    the output at the dense generic step's limit (test_torch_stt)."""
    from moshi_tpu.nn.attention import MHAConfig as JaxMHAConfig
    from moshi_tpu.nn.attention import streaming_mha as jax_streaming_mha
    from moshi_tpu_torch.nn.attention import MHAConfig, streaming_mha
    rng = np.random.default_rng(t + offset)
    d, h, cap = 64, 4, 8
    w_in = rng.normal(0, 1.5, (3 * d, d)).astype(np.float32)
    w_out = rng.normal(0, 0.1, (d, d)).astype(np.float32)
    x = rng.normal(0, 1, (2, t, d)).astype(np.float32)
    ring0 = _fp8_rings(rng, (2, cap, h, d // h))
    off = np.array([offset, offset + 3], np.int32)
    jcfg = JaxMHAConfig(dim=d, num_heads=h, context=cap,
                        kv_dtype=jnp.float8_e4m3fn)
    jp = {"in_proj": {"weight": jnp.asarray(w_in, jnp.bfloat16)},
          "out_proj": {"weight": jnp.asarray(w_out, jnp.bfloat16)}}
    ref, jstate = jax_streaming_mha(
        jcfg, jp, {"k": jnp.asarray(ring0[0]), "v": jnp.asarray(ring0[1])},
        jnp.asarray(x), jnp.asarray(off))
    cfg = MHAConfig(dim=d, num_heads=h, context=cap,
                    kv_dtype=torch.float8_e4m3fn)
    tp = {"in_proj": {"weight": _tbf16(jp["in_proj"]["weight"])},
          "out_proj": {"weight": _tbf16(jp["out_proj"]["weight"])}}
    got, state = streaming_mha(
        cfg, tp, {"k": _t8(ring0[0]), "v": _t8(ring0[1])},
        torch.from_numpy(x), torch.from_numpy(off))
    for name in ("k", "v"):
        np.testing.assert_array_equal(_tbits(state[name]),
                                      _f8_bits(jstate[name]))
    ref = np.asarray(ref)
    assert tl._rel_err(got.numpy(), ref) < ts._RTOL
