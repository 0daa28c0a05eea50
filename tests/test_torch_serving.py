"""The port's batched serving (``moshi_tpu_torch.runtime.serving``) and its
memory sizing (``runtime/memory.py``), on the CPU.

* The port's ``SessionPool`` against the JAX package's at B = 4, temp 0,
  over 14 ticks with staggered attaches, a detach and a re-attach in the
  middle, on the same weights and audio: the tiny q4_k LM and f32 Mimi of
  ``test_torch_pipeline.py``.  At B > 1 the LM's products take the dequant
  kernels on both sides (K2, K6, K8: JAX's Pallas kernels in interpret
  mode, the port's plain versions), whose products are exact in f32 and
  whose sums differ only in order.  A token and ``valid`` must match
  wherever JAX's top-1/top-2 logit gap exceeds the logits' limit
  (``_TOL``) of the row's largest magnitude, and the audio within ``_AUDIO_TOL``.
* Port-only pool tests in the manner of ``tests/test_serving.py``.
* ``memory.py`` with the card's memory patched to a stated value.
"""

import os

import jax
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.pipeline import STSPipeline as JaxSTSPipeline
from moshi_tpu.runtime.serving import SessionPool as JaxSessionPool
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime import memory
from moshi_tpu_torch.runtime.convert import params_from_numpy
from moshi_tpu_torch.runtime.pipeline import STSPipeline
from moshi_tpu_torch.runtime.serving import (SessionPool, auto_slots,
                                             reset_slots)
from moshi_tpu_torch.runtime.synth import synth_lm_params, synth_mimi_params
from tests.test_torch_pipeline import _LM, _MIMI, _SEANET, _mimi_params, _np

_B = 4
# (tick, action, session): attaches at ticks 0, 1, 3 and 5; "b" leaves at
# tick 6 and "e" takes its slot; "a" leaves at tick 9 and comes back at
# tick 10 as "a2" in the same slot, from offset 0, while its neighbours
# run on.
_SCHEDULE = [(0, "attach", "a"), (1, "attach", "b"), (3, "attach", "c"),
             (5, "attach", "d"), (6, "detach", "b"), (6, "attach", "e"),
             (9, "detach", "a"), (10, "attach", "a2")]
_TICKS = 14
# Both sides form the same exact products and sum them in f32 in another
# order: the text logits read <= 9e-7 of their row's largest magnitude
# here (limit 1e-5).  The depformer's carry is bf16, and at B > 1 its
# unfused layers round hh + o to it, so a last-bit difference that
# straddles a bf16 rounding moves a whole element: its logits read up to
# 2.0e-3 (limit 5e-3).  A token is decided where JAX's top-1/top-2 gap
# exceeds its logits' limit.
_TOL = (1e-5, 5e-3)       # text logits, depformer logits
# The decoded audio of equal codes: f32 Mimi, sums in another order.
_AUDIO_TOL = 1e-5


def _inputs(fs):
    """Each session's mic audio, one frame per tick it is attached."""
    rng = np.random.default_rng(12)
    return {sid: [(rng.normal(size=fs) * 0.1).astype(np.float32)
                  for _ in range(_TICKS)]
            for _, act, sid in _SCHEDULE if act == "attach"}


def _drive(pool, audio, logged):
    """Run the schedule; per tick, each attached session's result, its
    slot and the logits sampled that tick."""
    ticks = []
    age = {}
    for t in range(_TICKS):
        for tt, act, sid in _SCHEDULE:
            if tt == t:
                if act == "attach":
                    pool.attach(sid)
                    age[sid] = 0
                else:
                    pool.detach(sid)
        frames = {sid: audio[sid][age[sid]] for sid in pool._by_session}
        n0 = len(logged)
        outs = pool.tick(frames)
        for sid in frames:
            age[sid] += 1
        ticks.append({"outs": outs, "slots": dict(pool._by_session),
                      "logits": logged[n0:]})
    return ticks


def _run_jax(cfg, mcfg, lm_params, mimi_params, audio):
    mimi = JaxMimiModel(mcfg)
    logged = []
    orig_sample = jax_lm.sample_token

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    jax_lm.sample_token = sample
    enable_pallas(True)
    try:
        with pallas_interpret():
            pipe = JaxSTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                                  mimi_dtype=jax.numpy.float32)
            pool = JaxSessionPool(pipe, mimi_params, lm_params, batch=_B)
            ticks = _drive(_Barrier(pool), audio, logged)
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return ticks


class _Barrier:
    """A JAX pool whose tick waits for its debug callbacks, so that each
    tick's logits are logged before the next tick starts."""

    def __init__(self, pool):
        self._pool = pool

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def tick(self, frames):
        outs = self._pool.tick(frames)
        jax.effects_barrier()
        return outs


def _run_port(lm_params, mimi_params, audio):
    cfg = port_lm.LMConfig(**_LM)
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    logged = []
    orig_sample = port_lm.sample_token

    def sample(logits, *a, **kw):
        logged.append(logits.numpy().copy())
        return orig_sample(logits, *a, **kw)

    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    port_lm.sample_token = sample
    try:
        pipe = STSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                           mimi_dtype=torch.float32, device="cpu")
        pool = SessionPool(pipe, mimi_params, lm_params, batch=_B)
        ticks = _drive(pool, audio, logged)
    finally:
        port_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return ticks


@pytest.fixture(scope="module")
def pools():
    cfg = JaxLMConfig(**_LM)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    lm_params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
    mimi_params = _mimi_params(JaxMimiModel(mcfg), 4)
    fs = mcfg.seanet.hop_length * mcfg.frames_per_step
    audio = _inputs(fs)
    ref = _run_jax(cfg, mcfg, lm_params, mimi_params, audio)
    got = _run_port(params_from_numpy(_np(lm_params), device="cpu"),
                    params_from_numpy(_np(mimi_params), device="cpu"), audio)
    return ref, got


def _gap(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) / np.max(np.abs(logits), axis=-1)


def _undecided_flips(ref, got):
    """Per slot, the first tick where a token differs with JAX's gap
    within its limit (the streams legitimately part there), else
    _TICKS."""
    first = [_TICKS] * _B
    for t, (r, g) in enumerate(zip(ref, got)):
        for i, (lr, lg) in enumerate(zip(r["logits"], g["logits"])):
            flip = ((np.argmax(lr, -1) != np.argmax(lg, -1))
                    & (_gap(lr) <= _TOL[i > 0]))
            for s in np.nonzero(flip)[0]:
                first[s] = min(first[s], t)
    return first


def test_pool_schedule_and_logits_match_jax(pools):
    ref, got = pools
    assert len(ref) == len(got) == _TICKS
    for r, g in zip(ref, got):
        assert r["slots"] == g["slots"]
        assert set(r["outs"]) == set(g["outs"]) == set(r["slots"])
        # one text head and dep_q depformer steps per tick, all B rows
        assert len(r["logits"]) == len(g["logits"]) == 1 + _LM["dep_q"]
        for i, (lr, lg) in enumerate(zip(r["logits"], g["logits"])):
            assert lg.shape == lr.shape and lg.shape[0] == _B
            err = np.max(np.abs(lg - lr), -1) / np.max(np.abs(lr), -1)
            live = [slot for slot in r["slots"].values()]
            assert np.all(err[live] < _TOL[i > 0]), (i, err)
    # the re-attached slot restarted: "a2" holds "a"'s slot
    assert ref[-1]["slots"]["a2"] == ref[8]["slots"]["a"]


def test_pool_tokens_and_valid_match_jax_where_decided(pools):
    ref, got = pools
    first = _undecided_flips(ref, got)
    assert min(first) >= 12, f"streams parted at ticks {first}"
    checked = 0
    for t, (r, g) in enumerate(zip(ref, got)):
        for i, (lr, lg) in enumerate(zip(r["logits"], g["logits"])):
            decided = _gap(lr) > _TOL[i > 0]
            rows = [s for s in range(_B) if t < first[s] and decided[s]]
            np.testing.assert_array_equal(np.argmax(lg, -1)[rows],
                                          np.argmax(lr, -1)[rows])
            checked += len(rows)
        for sid, slot in r["slots"].items():
            if t < first[slot]:
                assert g["outs"][sid]["text"] == r["outs"][sid]["text"]
                assert g["outs"][sid]["valid"] == r["outs"][sid]["valid"]
    assert checked >= _TICKS * (1 + _LM["dep_q"])


def test_pool_audio_matches_jax(pools):
    ref, got = pools
    first = _undecided_flips(ref, got)
    fs = None
    for t, (r, g) in enumerate(zip(ref, got)):
        for sid, slot in r["slots"].items():
            if t >= first[slot]:
                continue
            a, b = g["outs"][sid]["audio_out"], r["outs"][sid]["audio_out"]
            fs = fs or b.shape[0]
            assert a.shape == b.shape == (fs,) and a.dtype == np.float32
            assert np.all(np.isfinite(a))
            err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
            assert err < _AUDIO_TOL, (t, sid, err)


def test_pool_reattached_slot_restarts_while_neighbours_run(pools):
    """After "a" leaves and "a2" takes its slot, "a2" is invalid through
    the delay lead-in while "c" and "d", older, stay valid, on both
    sides."""
    for ticks in pools:
        t = 10
        assert not ticks[t]["outs"]["a2"]["valid"]
        assert ticks[t]["outs"]["c"]["valid"]
        assert ticks[t]["outs"]["d"]["valid"]
        assert ticks[-1]["outs"]["a2"]["valid"]


# ---------------------------------------------------------------------------
# port-only pool tests (tests/test_serving.py's, on the port)
# ---------------------------------------------------------------------------

def _small_pool(batch=4):
    """The pool of the JAX comparison's configuration (the port's stacked
    depformer takes quantized weights only), at the sampling settings of
    tests/test_serving.py."""
    cfg = port_lm.LMConfig(**_LM)
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    pipe = STSPipeline(mimi, cfg, temp=0.8, temp_text=0.7, top_k=8,
                       top_k_text=8, mimi_dtype=torch.float32, device="cpu")
    return SessionPool(pipe, synth_mimi_params(mimi.cfg, device="cpu",
                                               seed=0),
                       synth_lm_params(cfg, "q4_k", device="cpu", seed=1),
                       batch=batch)


@pytest.fixture(scope="module")
def pool():
    return _small_pool()


def _frame(rng, fs):
    return rng.normal(size=fs).astype(np.float32) * 0.1


def test_attach_tick_detach(pool):
    rng = np.random.default_rng(0)
    fs = pool.pipe.frame_samples
    a = pool.attach("alice")
    b = pool.attach("bob")
    assert pool.active == 2 and a != b
    for _ in range(5):
        outs = pool.tick({"alice": _frame(rng, fs), "bob": _frame(rng, fs)})
    assert set(outs) == {"alice", "bob"}
    assert outs["alice"]["valid"] and outs["bob"]["valid"]
    assert outs["alice"]["audio_out"].shape == (fs,)
    assert outs["alice"]["audio_out"].dtype == np.float32
    assert isinstance(outs["bob"]["text"], int)
    pool.detach("alice")
    assert pool.active == 1


def test_slot_reuse_resets_state(pool):
    """bob is 5 frames old (valid); carol takes alice's slot and restarts
    from offset 0 (invalid through the delay lead-in)."""
    rng = np.random.default_rng(1)
    fs = pool.pipe.frame_samples
    pool.attach("carol")
    outs = pool.tick({"bob": _frame(rng, fs), "carol": _frame(rng, fs)})
    assert outs["bob"]["valid"]
    assert not outs["carol"]["valid"]
    off = pool.state["lm"]["offset"]
    i_bob, i_carol = pool._by_session["bob"], pool._by_session["carol"]
    assert off[i_bob] > off[i_carol] == 1
    assert int(pool.state["enc"]["offset"][i_carol]) == 2   # 2 positions


def test_pool_full(pool):
    while pool.active < pool.batch:
        pool.attach(f"s{pool.active}")
    with pytest.raises(RuntimeError, match="full"):
        pool.attach("overflow")
    with pytest.raises(ValueError, match="duplicate"):
        pool.attach("bob")


def test_masked_reset_of_reused_slots():
    """A detach and an attach reset exactly the re-attached slot (every
    state row back to a fresh session's) and leave the live ones."""
    p = _small_pool()
    fs = p.pipe.frame_samples
    rng = np.random.default_rng(2)
    p.attach("x")
    p.attach("y")
    for _ in range(3):
        p.tick({"x": _frame(rng, fs), "y": _frame(rng, fs)})
    before = {k: v.clone() for k, v in p.state["lm"]["transformer"].items()}
    p.detach("y")
    p.attach("z")
    off = p.state["lm"]["offset"]
    ix, iz = p._by_session["x"], p._by_session["z"]
    assert int(off[ix]) == 3 and int(off[iz]) == 0
    fresh = p.pipe.init_state(1)
    for name in ("k", "v"):
        ring = p.state["lm"]["transformer"][name]
        assert torch.equal(ring[:, iz], fresh["lm"]["transformer"][name][:, 0])
        assert torch.equal(ring[:, ix], before[name][:, ix])
        assert ring[:, ix].abs().sum() > 0
    assert torch.equal(p.state["dec"]["transformer"]["k"][:, iz],
                       fresh["dec"]["transformer"]["k"][:, 0])
    assert torch.equal(p.state["lm"]["cache"][iz], fresh["lm"]["cache"][0])


def test_fresh_rows_equal_the_b1_template():
    """Every row of a fresh B-wide state equals the B = 1 state (the batch
    axis taken by the reset's rule), so a B = 1 template resets a slot to
    what the JAX package's B-wide template gives."""
    p = _small_pool(batch=3)
    wide = p.pipe.init_state(3)
    one = p.pipe.init_state(1)
    seen = []

    def walk(a, b, name):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], key)
        elif isinstance(a, torch.Tensor) and a.dim() > 0:
            axis = 1 if name in ("k", "v") and a.dim() >= 3 else 0
            assert a.shape[axis] == 3 and b.shape[axis] == 1, name
            for s in range(3):
                assert torch.equal(a.select(axis, s), b.select(axis, 0))
            seen.append(name)

    walk(wide, one, None)
    assert seen.count("k") == 3 and "cache" in seen and "prev" in seen
    # and reset_slots copies the template in place
    state = p.pipe.init_state(3)
    state["lm"]["offset"].fill_(7)
    state["enc"]["transformer"]["v"].fill_(1.0)
    reset_slots(state, one, [0, 2])
    assert state["lm"]["offset"].tolist() == [0, 7, 0]
    v = state["enc"]["transformer"]["v"]
    assert v[:, 1].eq(1.0).all() and v[:, 0].eq(0).all() and \
        v[:, 2].eq(0).all()


# ---------------------------------------------------------------------------
# memory.py
# ---------------------------------------------------------------------------

_H100 = 80 * 10 ** 9      # the patched card: 80 GB


def test_memory_sizing(monkeypatch):
    monkeypatch.setattr(memory, "hbm_bytes", lambda device=None: _H100)
    cfg = port_lm.LMConfig()      # 7B: 32 layers x 3000 x 32 heads x 128
    per = memory.kv_bytes_per_session(cfg)
    assert per == 32 * 3000 * 32 * 128 * 2 * 2
    assert memory.kv_bytes_per_session(cfg, context=1500) == per // 2
    w = int(4.3e9)
    n = memory.suggest_sessions(cfg, w, kv_transient=1.0)
    assert n == (int(_H100 * 0.85) - w) // per
    assert memory.suggest_sessions(cfg, w, kv_transient=2.0) < n
    assert auto_slots(cfg, w) == max(1, min(
        memory.suggest_sessions(cfg, w), 64))
    assert auto_slots(cfg, w, cap=8) == 8
    ctx = memory.suggest_context(cfg, w, sessions=64)
    assert 0 < ctx < cfg.context


def test_auto_shrink_context(monkeypatch):
    monkeypatch.setattr(memory, "hbm_bytes", lambda device=None: _H100)
    cfg = port_lm.LMConfig()
    w = int(5.14e9)
    c1, shrunk, ctx = memory.auto_shrink_context(cfg, w, sessions=8)
    assert not shrunk and c1.context == ctx == cfg.context
    c2, shrunk2, ctx2 = memory.auto_shrink_context(cfg, w, sessions=64)
    assert shrunk2 and 8 <= c2.context < cfg.context
    assert ctx2 == c2.context and ctx2 % 8 == 0
    total = w + 64 * memory.kv_bytes_per_session(c2) * memory.KV_TRANSIENT
    assert total <= _H100 * 0.95


def test_hbm_bytes_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        memory.hbm_bytes("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            memory.hbm_bytes()
