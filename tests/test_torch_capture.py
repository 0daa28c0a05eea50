"""The port's capture recorder (``moshi_tpu_torch.utils.capture``) and its
taps against the JAX package's, on the CPU.

One stacked-decode LM frame and one Mimi encode + decode step are recorded
in both packages on the same weights and inputs: the tap names and the
execution order must be the same lists.  Float taps are held to the LM
tests' 2e-3 of their largest magnitude (``tests/test_torch_lm.py``: a
last-bit difference can flip an int8 activation rounding) and the Mimi
tests' 1e-5 in f32 (``tests/test_torch_mimi.py``); tokens must be equal
where JAX's top-1/top-2 gap exceeds 2e-3, and Mimi's codes equal.  JAX
runs its Pallas kernels in interpret mode; the port runs the plain
versions.  Also: the fusion is off while recording, a recorded ring is
the ring as it stood before the frame, the trace files, the reference
dump import, FrameTimer and the profiling scope.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models import lm as jax_lm
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.utils import capture as jax_capture
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.mimi import MimiModel
from moshi_tpu_torch.quant import fused as port_fused
from moshi_tpu_torch.runtime.synth import synth_lm_params
from moshi_tpu_torch.utils import capture
from moshi_tpu_torch.utils.capture import (TraceRecorder, compare_traces,
                                           load_reference_capture,
                                           recording, recording_active)
from moshi_tpu_torch.utils.prof import FrameTimer, scope
from tests.test_capture2 import _write_reference_dump
from tests.test_torch_gguf import jax_tree
from tests.test_torch_lm import _KW
from tests.test_torch_mimi import (_draw, _jax_cfg, _port_cfg, _to_torch)

_RTOL = 2e-3          # tests/test_torch_lm.py:54
_MIMI_TOL = 1e-5      # tests/test_torch_mimi.py, f32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _gap(logits):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) / np.max(np.abs(logits), axis=-1)


_LM = {}


def _lm_traces():
    """The first frame of a session at temp 0 recorded in both packages,
    and the port's second frame (its ring taps hold a written slot), with
    the ring before and after it."""
    if _LM:
        return _LM
    cfg = jax_lm.LMConfig(**_KW)
    pcfg = port_lm.LMConfig(**_KW)
    pparams = synth_lm_params(pcfg, "q4_k", device="cpu", seed=3)
    params = jax_tree(pparams)
    rng = np.random.default_rng(11)
    other = rng.integers(0, cfg.card, (2, 1, cfg.n_q - cfg.dep_q),
                         dtype=np.int32)
    enable_pallas(True)
    try:
        with pallas_interpret():
            state = jax_lm.init_gen_state(cfg, 1, jax.random.PRNGKey(5))
            with jax_capture.recording() as jrec:
                # traced under the recorder: its taps are callbacks to it
                step = jax.jit(lambda p, s, o: jax_lm.lm_gen_step(
                    cfg, p, s, other_audio=o, temp=0.0, temp_text=0.0))
                out, _ = step(params, state, jnp.asarray(other[0]))
                jax.block_until_ready(out["audio"])
            jax.effects_barrier()
    finally:
        enable_pallas(False)
    pstate = port_lm.init_gen_state(pcfg, 1, device="cpu")
    recs = []
    for f in range(2):
        before = pstate["transformer"]["k"].clone()
        with recording() as prec:
            _, pstate = port_lm.lm_gen_step(
                pcfg, pparams, pstate, other_audio=torch.from_numpy(other[f]),
                temp=0.0, temp_text=0.0)
        recs.append(prec)
    _LM.update(jax=jrec, port=recs[0], second=recs[1], ring_before=before,
               ring_after=pstate["transformer"]["k"], params=pparams,
               cfg=pcfg, other=other)
    return _LM


def _bf16_steps(got, ref):
    """Each element's distance from JAX's in bf16 steps."""
    def ordered(a):
        i = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16).view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(ref)).abs().numpy()


def _held(jrec, prec, tol):
    """Walk JAX's execution order: every float tap within ``tol`` of its
    largest magnitude (a bf16 tap: each element within that or within one
    bf16 step, since its rounding turns a last-bit difference into a whole
    step), every integer tap equal wherever the logits recorded just
    before it decide it (gap > tol).  Stops after a token that differs
    where undecided (a legitimate split: later taps see other inputs).
    Returns the number of taps compared."""
    last_logits = None
    compared = 0
    for name, i in jrec.order:
        ref = np.asarray(jrec.values[name][i])
        got = prec.values[name][i]
        assert got.shape == ref.shape, (name, i, got.shape, ref.shape)
        compared += 1
        if ref.dtype.kind in "iub":
            if name.endswith("offset"):
                np.testing.assert_array_equal(got, ref, err_msg=name)
                continue
            decided = (_gap(last_logits) > tol).reshape(ref.shape)
            np.testing.assert_array_equal(got[decided], ref[decided],
                                          err_msg=f"{name}@{i}")
            if np.any(got != ref):
                break
            continue
        ref = ref.astype(np.float32)
        if prec.dtypes[name][i] == "bfloat16":
            close = np.abs(got - ref) <= tol * np.max(np.abs(ref))
            assert np.all(close | (_bf16_steps(got, ref) <= 1)), (name, i)
        else:
            assert _rel(got, ref) <= tol, (name, i, _rel(got, ref))
        if name.endswith("logits"):
            last_logits = ref
    return compared


def test_lm_frame_taps_and_order_match_jax():
    r = _lm_traces()
    jrec, prec = r["jax"], r["port"]
    assert set(prec.values) == set(jrec.values)
    assert prec.order == jrec.order
    assert any(n == "lm/temporal/ring_k" for n, _ in prec.order)
    assert len(prec.values["lm/temporal/qkv"]) == r["cfg"].num_layers
    assert len(prec.values["lm/dep/token"]) == r["cfg"].dep_q
    assert _held(jrec, prec, _RTOL) == len(jrec.order)


def test_recorded_ring_is_the_ring_before_the_frame():
    """The ring is written in place after its tap: the recorder holds its
    own copy of the ring as it stood before the frame."""
    r = _lm_traces()
    got = r["second"].values["lm/temporal/ring_k"][0]
    assert np.any(got != 0)
    np.testing.assert_array_equal(got, r["ring_before"].float().numpy())
    assert not np.array_equal(got, r["ring_after"].float().numpy())
    assert r["second"].dtypes["lm/temporal/ring_k"][0] == "bfloat16"
    assert r["second"].order == r["port"].order


def test_fusion_off_while_recording_and_on_after():
    r = _lm_traces()
    cfg, params = r["cfg"], r["params"]
    calls = []
    orig = port_fused.attn_ffn_fused_plain

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    port_fused.attn_ffn_fused_plain = counted
    try:
        def frame():
            state = port_lm.init_gen_state(cfg, 1, device="cpu")
            port_lm.lm_gen_step(cfg, params, state,
                                other_audio=torch.from_numpy(r["other"][0]),
                                temp=0.0, temp_text=0.0)
        with recording():
            assert recording_active()
            frame()
        assert calls == []
        assert not recording_active()
        frame()
    finally:
        port_fused.attn_ffn_fused_plain = orig
    assert len(calls) == cfg.num_layers + cfg.dep_q * cfg.depformer_layers


def test_mimi_step_taps_and_order_match_jax():
    jm = JaxMimiModel(_jax_cfg())
    pm = MimiModel(_port_cfg())
    params = _draw(jm.init_params, 1)
    pparams = _to_torch(params)
    rng = np.random.default_rng(4)
    audio = rng.normal(size=(1, jm.cfg.seanet.hop_length * 2)).astype(
        np.float32) * 0.1
    with jax_capture.recording() as jrec:
        codes, _ = jm.encode_step(params, jm.init_encode_state(1),
                                  jnp.asarray(audio))
        wav, _ = jm.decode_step(params, jm.init_decode_state(1), codes)
        jax.block_until_ready(wav)
    jax.effects_barrier()
    with recording() as prec:
        pcodes, _ = pm.encode_step(pparams,
                                   pm.init_encode_state(1, device="cpu"),
                                   torch.from_numpy(audio))
        pm.decode_step(pparams, pm.init_decode_state(1, device="cpu"),
                       pcodes)
    assert set(prec.values) == set(jrec.values)
    assert prec.order == jrec.order
    names = set(prec.values)
    assert any(n.startswith("mimi/enc/model.") and n.endswith(":prev")
               for n in names)
    assert any(n.startswith("mimi/dec/model.") and n.endswith(":partial")
               for n in names)
    assert len(prec.values["mimi/enc_tx/attn_out"]) == \
        jm.cfg.transformer_layers
    for name, i in jrec.order:
        ref = np.asarray(jrec.values[name][i])
        got = prec.values[name][i]
        assert got.shape == ref.shape, name
        if ref.dtype.kind in "iu":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            assert _rel(got, ref) <= _MIMI_TOL, (name, _rel(got, ref))


def test_capture_off_is_a_pass_through(monkeypatch):
    monkeypatch.setattr(capture, "_DEBUG_SUMS", False)
    t = torch.ones(3)
    assert capture.capture("x", t) is t
    assert not recording_active()


def test_debug_sums_print_each_tap(monkeypatch, capsys):
    monkeypatch.setattr(capture, "_DEBUG_SUMS", True)
    assert recording_active()
    t = torch.tensor([1.0, 2.0, 0.5], dtype=torch.bfloat16)
    assert capture.capture("lm/embed", t) is t
    assert capsys.readouterr().out == "lm/embed: sum=3.5\n"


def test_debug_sums_are_read_from_the_environment_at_import(monkeypatch):
    import importlib.util
    for env, on in (("1", True), ("", False)):
        monkeypatch.setenv("MOSHI_TPU_DEBUG_SUMS", env)
        spec = importlib.util.spec_from_file_location("capture_copy",
                                                      capture.__file__)
        copy = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(copy)
        assert copy._DEBUG_SUMS is on
        assert copy.recording_active() is on


def test_trace_files_round_trip(tmp_path):
    r = _lm_traces()
    rec = r["port"]
    path = str(tmp_path / "frame")
    rec.dump_graph(path)
    loaded = TraceRecorder.load(path + ".npz")
    assert len(loaded) == len(rec.order)
    with open(path + ".json") as fh:
        doc = json.load(fh)
    assert [(d["name"], d["occurrence"]) for d in doc["order"]] == rec.order
    meta = doc["tensors"]["lm/temporal/attn_ctx@0"]
    assert meta["dtype"] == "bfloat16"
    assert loaded["lm/temporal/attn_ctx@0"].dtype == np.float32
    assert doc["tensors"]["lm/temporal/qkv@1"]["dtype"] == "float32"
    assert doc["tensors"]["lm/text_token@0"]["dtype"] == "int64"
    assert ".py:" in meta["caller"]
    ok, lines = compare_traces(loaded, loaded)
    assert ok and all(ln.startswith("OK") for ln in lines)
    rec.save(str(tmp_path / "t.npz"))
    again = TraceRecorder.load(str(tmp_path / "t.npz"))
    ok, lines = compare_traces(loaded, again)
    assert ok, lines
    bad = dict(again)
    bad["lm/embed@0"] = bad["lm/embed@0"] + 1.0
    del bad["lm/transformer_out@0"]
    bad["extra@0"] = np.zeros(1)
    ok, lines = compare_traces(loaded, bad)
    assert not ok
    assert "MISSING lm/transformer_out@0" in lines
    assert any(ln.startswith("FAIL lm/embed@0") for ln in lines)
    assert lines[-1] == "EXTRA extra@0"


def test_reference_dump_import(tmp_path, rng):
    a = rng.normal(size=(3, 8)).astype(np.float32)
    b = rng.integers(0, 9, (4,), dtype=np.int32)
    c = rng.normal(size=(2, 2, 5)).astype(np.float32)
    jp = _write_reference_dump(tmp_path, [("lm/embed", a, "mul_mat"),
                                          ("tokens", b, "get_rows"),
                                          ("h3", c, "add")])
    values, meta = load_reference_capture(jp)
    ref_values, ref_meta = jax_capture.load_reference_capture(jp)
    assert set(values) == set(ref_values)
    for k in values:
        np.testing.assert_array_equal(values[k], ref_values[k])
    assert meta == ref_meta
    np.testing.assert_array_equal(values["h3"], c)
    assert meta["0"]["op"] == "mul_mat"
    ok, lines = compare_traces({"lm/embed": a}, {"lm/embed": a + 1e-7})
    assert ok, lines
    assert not compare_traces({"lm/embed": a}, {"lm/embed": a + 1.0})[0]


def test_frame_timer_and_scope():
    t = FrameTimer(budget_ms=80.0)
    assert t.report() == {"frames": 0, "fps": 0.0, "p50_ms": 0.0,
                          "p95_ms": 0.0, "p99_ms": 0.0, "over_budget": 0,
                          "realtime": True}
    t.samples = [10.0, 20.0, 30.0, 100.0]
    rep = t.report()
    assert rep["frames"] == 4 and rep["over_budget"] == 1
    assert rep["p50_ms"] == 25.0 and rep["realtime"]
    assert rep["fps"] == round(4 / 0.16, 2)
    with t.frame():
        pass
    assert len(t.samples) == 5 and t.samples[-1] >= 0.0
    with torch.profiler.profile() as prof:
        with scope("moshi/frame"):
            torch.ones(4).add_(1)
    assert any(e.name == "moshi/frame" for e in prof.events())
