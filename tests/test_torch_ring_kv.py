"""K11's pair entry and K4 at positions past the ring, on the CPU.

* ``ring_write_kv`` (one launch for a layer's k and v rows on the card;
  here its plain version) against JAX's ``ring_insert`` at T = 1 with
  Pallas on, in interpret mode, for k and then v: bf16 and fp8 rings, f32
  and bf16 rows (values past 464, at bf16 and e4m3 ties, subnormals,
  inf), B = 1 and 3 with each session at its own offset, some past cap
  (0, 5, cap - 1, cap, 2 cap + 7, 2^31 - 1), the rows strided views into
  a qkv projection as ``streaming_mha`` passes them.  Bit for bit, an fp8
  ring read through its uint8 view.
* ``ring_write`` (the one-ring entry) the same way, at positions past cap.
* K4's wrapper given the offsets themselves against JAX's
  ``ring_write_stacked`` at offset % cap (what the JAX stacked decode
  passes it).
* ``streaming_mha`` at T = 1 writes both rings in one ``ring_write_kv``
  call, with the offset as the caller holds it and the rows as views.
* The wrappers run the plain versions on CPU tensors and raise on
  operands the kernel does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.nn.attention import ring_insert as jax_ring_insert
from moshi_tpu.nn.pallas_ring import ring_write as jax_ring_write4
from moshi_tpu.nn.pallas_ring import ring_write_stacked as jax_ring_write
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.nn import attention as port_attention
from moshi_tpu_torch.nn import ring as port_ring
from test_torch_fp8 import _t8, _tbf16, probe_values

CAP, H, HD = 12, 2, 64
INT32_MAX = 2 ** 31 - 1
OFFSETS = (0, 5, CAP - 1, CAP, 2 * CAP + 7, INT32_MAX)


def _jax_dtype(ring):
    return jnp.bfloat16 if ring == "bf16" else jnp.float8_e4m3fn


def _bits(a):
    """A JAX or numpy array's bits (uint8 for fp8, uint16 for bf16)."""
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint16)


def _tbits(t):
    return (t.view(torch.uint8) if t.dtype == port_ring.FP8
            else t.view(torch.int16)).numpy().view(
        np.uint8 if t.dtype == port_ring.FP8 else np.uint16)


def _row_values(rng, n, ring):
    """n f32 values, shuffled: 448-465, 480, 1e6, +-inf, bf16 ties and
    their f32 neighbours (and NaN for an fp8 ring, where both packages
    write the rule's NaN) in every draw; then a random half of n from the
    fp8 probe (every e4m3 tie and its neighbours, e4m3 values,
    subnormals); the rest N(0, 8)."""
    edge = np.array([448, 449, 464, np.nextafter(np.float32(464),
                                                 np.float32(1e9)),
                     465, 480, 1e6, np.inf, 2.0 ** -9, 3 * 2.0 ** -11],
                    np.float32)
    ties = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 300 + 2.0 ** -1],
                    np.float32)
    ties = np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, np.float32(-np.inf))])
    x = np.concatenate([edge, ties, [np.nan] if ring == "fp8" else []])
    x = np.concatenate([x, -x])
    probe = probe_values()
    probe = probe[~np.isnan(probe)]
    x = np.concatenate([x, rng.choice(probe, n // 2, replace=False)])
    assert n >= x.size
    x = np.concatenate([x, rng.normal(0, 8, n - x.size)]).astype(np.float32)
    return rng.permutation(x)


def _rings(rng, b, ring):
    """Two random rings [b, CAP, H, HD] as (jax, torch), bit for bit."""
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.normal(0, 1, (b, CAP, H, HD)).astype(np.float32))
        j = x.astype(_jax_dtype(ring))
        t = (_t8(j) if ring == "fp8" else _tbf16(j)).clone()
        out.append((j, t))
    return out


def _qkv(rng, b, rows, ring):
    """A projection's output [b, 1, 3D] (f32 or bf16, as jax and torch
    arrays) whose k and v parts hold ``_row_values``."""
    d = H * HD
    x = _row_values(rng, b * 3 * d, ring).reshape(b, 1, 3 * d)
    j = jnp.asarray(x)
    if rows == "bf16":
        j = j.astype(jnp.bfloat16)
        return j, _tbf16(j)
    return j, torch.from_numpy(x)


def _kv_views(qkv, b):
    """k and v [b, H, HD] as ``streaming_mha`` takes them from qkv
    (without rope): strided views, the sessions 3D apart."""
    d = H * HD
    k = qkv[..., d:2 * d].reshape(b, 1, H, HD)
    v = qkv[..., 2 * d:].reshape(b, 1, H, HD)
    return k, v


def _session_offsets(b):
    """Per-session offsets: each of OFFSETS at B = 1, three sets at B = 3
    (different per session, some past cap)."""
    if b == 1:
        return [[o] for o in OFFSETS]
    return [[0, CAP + 5, 2 * CAP + 7], [CAP - 1, INT32_MAX, 5],
            [CAP, 3, INT32_MAX - 4]]


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("ring", ["bf16", "fp8"])
def test_ring_write_kv_matches_ring_insert(ring, rows, b):
    rng = np.random.default_rng(
        {"bf16": 0, "fp8": 1}[ring] * 4 + {"f32": 0, "bf16": 1}[rows] * 2
        + b)
    (jk, tk), (jv, tv) = _rings(rng, b, ring)
    for offs in _session_offsets(b):
        jqkv, tqkv = _qkv(rng, b, rows, ring)
        jkr, jvr = _kv_views(jqkv, b)
        tkr, tvr = _kv_views(tqkv, b)
        assert b == 1 or not tkr[:, 0].is_contiguous()
        pos = np.array(offs, np.int32)
        enable_pallas(True)
        try:
            with pallas_interpret():
                jk = jax_ring_insert(jk, jkr, jnp.asarray(pos)[:, None], CAP)
                jv = jax_ring_insert(jv, jvr, jnp.asarray(pos)[:, None], CAP)
        finally:
            enable_pallas(False)
        out = port_ring.ring_write_kv(tk, tv, tkr[:, 0], tvr[:, 0],
                                      torch.from_numpy(pos))
        assert out[0] is tk and out[1] is tv
        np.testing.assert_array_equal(_tbits(tk), _bits(jk), err_msg=str(offs))
        np.testing.assert_array_equal(_tbits(tv), _bits(jv), err_msg=str(offs))
    if ring == "fp8" and rows == "f32":
        assert ((_tbits(tk) & 0x7F) == 0x7F).any()     # NaN was written


@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("ring", ["bf16", "fp8"])
def test_ring_write_one_ring_at_positions_past_cap(ring, pos_dtype):
    rng = np.random.default_rng(7)
    b = 3
    (jc, tc), _ = _rings(rng, b, ring)
    for offs in _session_offsets(b):
        x = _row_values(rng, b * H * HD, ring).reshape(b, H, HD)
        ref = jax_ring_write4(jc, jnp.asarray(x),
                              jnp.asarray(np.array(offs, np.int64) % CAP,
                                          jnp.int32), interpret=True)
        port_ring.ring_write(tc, torch.from_numpy(x),
                             torch.tensor(offs, dtype=pos_dtype))
        np.testing.assert_array_equal(_tbits(tc), _bits(ref))
        jc = ref


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("ring, rows", [("bf16", "bf16"), ("bf16", "f32"),
                                        ("fp8", "f32"), ("fp8", "bf16")])
def test_ring_write_stacked_at_offsets(ring, rows, b):
    """K4's wrapper takes the offsets and writes at their floor mod, as
    JAX's stacked decode writes at ``offset % cap``."""
    rng = np.random.default_rng(11)
    nl = 2
    rings = []
    for _ in range(2):
        x = jnp.asarray(rng.normal(0, 1, (nl, b, CAP, H, HD))
                        .astype(np.float32)).astype(_jax_dtype(ring))
        rings.append((x, (_t8(x) if ring == "fp8" else _tbf16(x)).clone()))
    (jk, tk), (jv, tv) = rings
    for offs in _session_offsets(b):
        kv = []
        for _ in range(2):
            x = _row_values(rng, nl * b * H * HD, ring).reshape(nl, b, H, HD)
            j = jnp.asarray(x)
            if rows == "bf16":
                j = j.astype(jnp.bfloat16)
                kv.append((j, _tbf16(j)))
            else:
                kv.append((j, torch.from_numpy(x)))
        slot = jnp.asarray(np.array(offs, np.int64) % CAP, jnp.int32)
        jk, jv = jax_ring_write(jk, jv, kv[0][0], kv[1][0], slot,
                                interpret=True)
        port_ring.ring_write_stacked(tk, tv, kv[0][1], kv[1][1],
                                     torch.tensor(offs, dtype=torch.int32))
        np.testing.assert_array_equal(_tbits(tk), _bits(jk))
        np.testing.assert_array_equal(_tbits(tv), _bits(jv))


def test_streaming_mha_writes_both_rings_in_one_call(monkeypatch):
    """At T = 1 on 4-D rings ``streaming_mha`` calls ``ring_write_kv``
    once, with the offset tensor it was given and the k and v rows as
    views (no copy), and writes what two ``ring_insert`` calls write."""
    torch.manual_seed(0)
    b, d = 3, H * HD
    cfg = port_attention.MHAConfig(dim=d, num_heads=H, context=CAP)
    params = {"in_proj": {"weight": torch.randn(3 * d, d).to(torch.bfloat16)},
              "out_proj": {"weight": torch.randn(d, d).to(torch.bfloat16)}}
    x = torch.randn(b, 1, d)
    offset = torch.tensor([0, CAP + 5, INT32_MAX], dtype=torch.int32)
    state = port_attention.init_kv_state(cfg, b, "cpu")
    ref = {k: v.clone() for k, v in state.items()}
    calls = []
    orig = port_attention.ring_write_kv

    def spy(k_ring, v_ring, k_rows, v_rows, pos):
        calls.append((k_rows, v_rows, pos))
        return orig(k_ring, v_ring, k_rows, v_rows, pos)

    monkeypatch.setattr(port_attention, "ring_write_kv", spy)
    port_attention.streaming_mha(cfg, params, state, x, offset)
    assert len(calls) == 1
    k_rows, v_rows, pos = calls[0]
    assert pos is offset
    assert not k_rows.is_contiguous() and not v_rows.is_contiguous()
    assert v_rows.stride(0) == 3 * d
    # the same writes through ring_insert, k then v
    shared = port_attention.attn_shared(cfg, offset, 1)
    for name, rows in (("k", k_rows), ("v", v_rows)):
        port_attention.ring_insert(ref[name], rows[:, None],
                                   shared["positions"], CAP)
        assert torch.equal(state[name].view(torch.int16),
                           ref[name].view(torch.int16))


def test_ring_wrappers_run_plain_on_cpu(monkeypatch):
    """CPU tensors go to the plain versions; nothing is built, launched
    or counted."""
    def no_launch(*a, **kw):
        raise AssertionError("launched on CPU tensors")

    monkeypatch.setattr(port_ring, "_launch", no_launch)
    monkeypatch.setattr(build, "entry", no_launch)
    seen = []
    orig = port_ring.ring_write_kv_plain
    monkeypatch.setattr(port_ring, "ring_write_kv_plain",
                        lambda *a: seen.append(a) or orig(*a))
    before = dict(build.COUNTS)
    k = torch.zeros((1, CAP, H, HD), dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    rows = torch.ones((1, H, HD))
    port_ring.ring_write_kv(k, v, rows, 2 * rows,
                            torch.tensor([CAP + 1], dtype=torch.int32))
    assert len(seen) == 1 and dict(build.COUNTS) == before
    assert (k[0, 1] == 1).all() and (v[0, 1] == 2).all()
    assert k[0, :1].abs().sum() == 0 and k[0, 2:].abs().sum() == 0


def _operands(case):
    """Rings, rows and positions for one refused case of ``_launch``."""
    b = 2
    ring_dt = torch.int8 if case == "int8 ring" else port_ring.FP8 \
        if case == "fp8 ring, row of 24" else torch.bfloat16
    hd = 12 if case == "fp8 ring, row of 24" else HD
    k = torch.zeros((b, CAP, 2, hd), dtype=ring_dt)
    v = torch.zeros_like(k)
    row_dt = torch.float16 if case == "f16 rows" else torch.float32
    x = torch.zeros((b, 2, hd), dtype=row_dt)
    y = torch.zeros((b, 2, hd), dtype=torch.bfloat16 if case ==
                    "mixed rows" else row_dt)
    if case == "transposed rows":
        x = torch.zeros((b, hd, 2)).transpose(1, 2)
    if case == "odd stride":
        x = torch.zeros((b, 2 * hd + 1))[:, :2 * hd].view(b, 2, hd)
    pos = torch.tensor([0, 1], dtype=torch.float32 if case == "float pos"
                       else torch.int32)
    if case == "pos of 3":
        pos = torch.tensor([0, 1, 2], dtype=torch.int32)
    return (("k_ring", k), ("v_ring", v)), (("k_rows", x), ("v_rows", y)), \
        pos


@pytest.mark.parametrize("case", ["int8 ring", "f16 rows", "mixed rows",
                                  "fp8 ring, row of 24", "transposed rows",
                                  "odd stride", "float pos", "pos of 3"])
def test_ring_launch_refuses_what_the_kernel_does_not_take(case,
                                                           monkeypatch):
    """The checks before the launch raise on a ring or row dtype the
    kernel does not take, rows it cannot read in 16-byte vectors one
    stride apart, and positions not [B] int32/int64 on the rings'
    device; the launch is never reached."""
    def no_entry(*a, **kw):
        raise AssertionError("reached the launch")

    monkeypatch.setattr(build, "entry", no_entry)
    rings, rows, pos = _operands(case)
    with pytest.raises(ValueError):
        port_ring._launch("ring_write4", rings, rows, pos, 1)


def test_row_stride_reads_streaming_mha_views():
    """The stride K11 takes for ``streaming_mha``'s k and v views: the
    projection's row width (3D) or the rope output's (2D); one session's
    rows take the row itself."""
    b, d = 3, H * HD
    qkv = torch.zeros((b, 1, 3 * d))
    k, v = _kv_views(qkv, b)
    assert port_ring._row_stride(k[:, 0], d) == 3 * d
    assert port_ring._row_stride(v[:, 0], d) == 3 * d
    qk = torch.zeros((b, 1, 2 * H, HD))
    assert port_ring._row_stride(qk[:, 0, H:], d) == 2 * d
    assert port_ring._row_stride(qkv[:1, 0, d:2 * d], d) == d
    assert port_ring._row_stride(torch.zeros((2, b, H, HD)), d) == d
