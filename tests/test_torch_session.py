"""The port's streaming sessions (``moshi_tpu_torch.runtime.session``:
``LMGenerator``, ``MimiStreamer``, ``FINAL_PADDING``) against the JAX
package's, on the CPU, at temp 0.

Sizes as ``tests/test_session.py``: its tiny f32 LM (card 32, a 32-slot
temporal ring, so that 40 frames wrap it) with JAX's ``init_lm_params``
weights, and its tiny f32 Mimi (context 8, codebook size 32), carried
across by ``runtime/convert.py``.  The JAX side runs its Pallas kernels
in interpret mode; the port, every kernel's plain version.  Inputs are
seeded numpy draws.

Tolerances: every token, flag, offset and Mimi code equal; the decoded
audio within ``_AUDIO_TOL`` of its largest value (f32 Mimi, sums in
another order, as ``test_torch_pipeline.py``'s frames).
"""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from moshi_tpu.models import state_machine as jax_sm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.lm import init_lm_params
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.models.tts import make_voice_prefix as jax_voice_prefix
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime import session as jax_session
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import state_machine as port_sm
from moshi_tpu_torch.models.lm import LMConfig
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.models.tts import make_voice_prefix
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime import session
from moshi_tpu_torch.runtime.convert import params_from_numpy
from tests.test_torch_pipeline import _np

# test_session.py's LM and Mimi
_LM = dict(dim=32, num_heads=4, num_layers=2, hidden_dim=64, context=32,
           card=32, n_q=4, dep_q=2, text_card=48, delays=(0, 0, 1, 1, 2),
           depformer_dim=16, depformer_heads=2, depformer_layers=2,
           depformer_hidden=32, depformer_low_rank=8)
# its TTS form: the depformer replaced while the offset is below 2
_TTS = dict(_LM, delay_steps=2)
_MIMI = dict(n_q=4, total_codebooks=4, dim=32, codebook_dim=16,
             codebook_size=32, transformer_layers=1, transformer_heads=4,
             transformer_context=8, transformer_hidden=64)
_SEANET = dict(dimension=32, n_filters=4, ratios=(4, 3, 2, 2))
_FRAMES = 40
_AUDIO_TOL = 1e-5
_SCRIPT = [([10, 11], "hi", 0), ([12], "there", 1), ([], "<break>", 1),
           ([13, 14], "you", 0)]
_KEYS = ("sampled_text", "text", "audio", "has_audio")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread hand-offs
    than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_mode():
    """The JAX package with its Pallas kernels in interpret mode."""
    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    enable_pallas(True)
    try:
        with pallas_interpret():
            yield
    finally:
        enable_pallas(False)
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old


@pytest.fixture(scope="module")
def lm_params():
    """(JAX params, port params) of the tiny LM (the TTS form has the same
    tree)."""
    jp = init_lm_params(jax.random.PRNGKey(0), JaxLMConfig(**_LM))
    return jp, params_from_numpy(_np(jp), device="cpu")


def _pair(kw, params, **opts):
    """JAX's and the port's LMGenerator on the same weights and options;
    ``machine`` builds each package's StateMachine with these kwargs."""
    jp, pp = params
    mkw = opts.pop("machine", None)
    jm = None if mkw is None else jax_sm.StateMachine(**mkw)
    pm = None if mkw is None else port_sm.StateMachine(**mkw)
    with _jax_mode():
        jg = jax_session.LMGenerator(JaxLMConfig(**kw), jp, machine=jm,
                                     **opts)
    pg = session.LMGenerator(LMConfig(**kw), pp, machine=pm, device="cpu",
                             **opts)
    return jg, pg


def _step(gen, fn="receive"):
    with _jax_mode():
        out = getattr(gen, fn)()
    return {k: np.asarray(v) for k, v in out.items()}


def _equal(ref, got):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].shape == ref[k].shape, k


def test_sts_loop_at_b2_matches_jax(lm_params):
    """send2 / receive over 40 frames (the temporal ring wraps) at B = 2:
    every output equal to JAX's generator's, and audio comes."""
    jg, pg = _pair(_LM, lm_params, batch=2, temp=0.0, temp_text=0.0,
                   seed=1)
    rng = np.random.default_rng(0)
    others = rng.integers(0, 32, size=(_FRAMES, 2, 2))
    audio = 0
    for o in others:
        jg.send2(o)
        pg.send2(o)
        ref, got = _step(jg), _step(pg)
        _equal(ref, got)
        assert got["audio"].shape == (2, 2)
        audio += int(got["has_audio"].sum())
    assert audio >= _FRAMES
    assert pg.is_active() and jg.is_active()      # no machine: always


def test_batched_sessions_equal_separate_runs(lm_params):
    """Two sessions in one batch give what each gives alone, over 40
    frames."""
    _, pp = lm_params
    rng = np.random.default_rng(7)
    others = rng.integers(0, 32, size=(_FRAMES, 2, 2))

    def run(rows):
        gen = session.LMGenerator(LMConfig(**_LM), pp, batch=len(rows),
                                  temp=0.0, temp_text=0.0, device="cpu")
        outs = []
        for o in others:
            gen.send2(o[rows])
            outs.append(gen.receive())
        return outs

    both, only0, only1 = run([0, 1]), run([0]), run([1])
    for b, o0, o1 in zip(both, only0, only1):
        for k in _KEYS:
            np.testing.assert_array_equal(b[k][0:1], o0[k])
            np.testing.assert_array_equal(b[k][1:2], o1[k])


def test_sampling_follows_the_seed(lm_params):
    """At temp > 0 the port's generator draws from its seed: one seed
    repeats its outputs after ``reset``, another changes them."""
    _, pp = lm_params
    rng = np.random.default_rng(3)
    others = rng.integers(0, 32, size=(12, 1, 2))
    gen = session.LMGenerator(LMConfig(**_LM), pp, top_k=8, top_k_text=8,
                              seed=4, device="cpu")

    def run(seed):
        gen.reset(seed)
        outs = []
        for o in others:
            gen.send2(o)
            outs.append(gen.receive())
        return np.concatenate([np.concatenate([o["text"], o["audio"][0]])
                               for o in outs])

    first = run(4)
    np.testing.assert_array_equal(run(4), first)
    assert not np.array_equal(run(5), first)


def _script(module):
    return [module.Entry(list(t), w, padding=p) for t, w, p in _SCRIPT]


_MACHINE = dict(text_card=_LM["text_card"] + 1, max_padding=4,
                initial_padding=1)


def test_tts_with_the_machine_matches_jax(lm_params):
    """The text StateMachine between the phases, the depformer replaced
    while the offset is below delay_steps, and ``is_active`` with
    FINAL_PADDING: the same frames, outputs and end as JAX's, until both
    are inactive."""
    assert session.FINAL_PADDING == jax_session.FINAL_PADDING == 4
    jg, pg = _pair(_TTS, lm_params, temp=0.0, temp_text=0.0, seed=2,
                   machine=_MACHINE)
    for jentry, pentry in zip(_script(jax_sm), _script(port_sm)):
        jg.send(jentry)
        pg.send(pentry)
    frames = 0
    while jg.is_active() and frames < 60:
        assert pg.is_active() and pg.is_empty() == jg.is_empty()
        ref, got = _step(jg), _step(pg)
        _equal(ref, got)
        if frames < _TTS["delay_steps"]:
            assert not got["has_audio"].any()
        frames += 1
    assert not pg.is_active()
    end = pg.machine_state.end_step
    assert end == jg.machine_state.end_step >= 0
    assert frames == end + _TTS["delay_steps"] + session.FINAL_PADDING
    assert pg.is_empty()
    pg.machine_reset()
    assert pg.machine_state.end_step == -1 and pg.is_active(slot=0)


def test_text_prefixes_match_jax(lm_params):
    """Queued text prefixes replace the machine's tokens, in order."""
    jg, pg = _pair(_TTS, lm_params, temp=0.0, temp_text=0.0, seed=3,
                   machine=dict(text_card=_LM["text_card"] + 1))
    for g in (jg, pg):
        g.text_prefixes.extend([21, 22])
    for want in (21, 22, None):
        ref, got = _step(jg, "step"), _step(pg, "step")
        _equal(ref, got)
        if want is not None:
            assert int(got["sampled_text"][0]) == want


def test_audio_prefix_and_skip_match_jax(lm_params):
    """An audio prefix is forced into the delay cache, and the next
    ``skip_prefix`` frames give no audio."""
    jg, pg = _pair(_LM, lm_params, temp=0.0, temp_text=0.0, seed=4)
    for g in (jg, pg):
        g.audio_prefixes.append([5, 6])
    for f in range(4):
        ref, got = _step(jg, "step"), _step(pg, "step")
        _equal(ref, got)
        if f < pg.skip_prefix:
            assert not got["has_audio"].any()
    np.testing.assert_array_equal(pg.state["cache"].numpy(),
                                  np.asarray(jg.state["cache"]))
    c = pg.state["cache"].numpy()
    assert c[0, 1, 1] == 5 and c[0, 1, 2] == 6


def test_receive2_has_no_lead_in(lm_params):
    """receive2 (the STT side) never replaces the depformer: against JAX's
    with delay_steps > 0."""
    jg, pg = _pair(_TTS, lm_params, temp=0.0, temp_text=0.0, seed=6)
    rng = np.random.default_rng(9)
    for o in rng.integers(0, 32, size=(4, 1, 2)):
        jg.send2(o)
        pg.send2(o)
        _equal(_step(jg, "receive2"), _step(pg, "receive2"))


# ---------------------------------------------------------------------------
# MimiStreamer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mimi():
    """(JAX MimiStreamer factory, port MimiStreamer factory), both on the
    same weights."""
    jcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    jm = JaxMimiModel(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    pm = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    pparams = params_from_numpy(_np(jparams), device="cpu")

    def make(batch=1):
        with _jax_mode():
            js = jax_session.MimiStreamer(jm, jparams, batch=batch)
        return js, session.MimiStreamer(pm, pparams, batch=batch,
                                        device="cpu")

    return make


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def test_mimi_streamer_matches_jax(mimi):
    """Streaming encode of single frames and a two-frame call: codes equal
    (int32, [B, n, n_q]); decode of them, of a [B, n_q] frame, of codes
    short of n_q books and of -1 codes: audio within ``_AUDIO_TOL``.
    ``reset`` starts the streams again."""
    js, ps = mimi(batch=2)
    rng = np.random.default_rng(1)
    fs = MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI).frame_samples
    for n in (1, 1, 2):
        audio = (rng.normal(size=(2, n * fs)) * 0.1).astype(np.float32)
        with _jax_mode():
            ref = js.encode(audio)
        got = ps.encode(audio)
        assert got.shape == (2, n, 4) and got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        for codes in (got, got[:, 0], got[:, :, :2],
                      np.where(got > 20, -1, got)):
            with _jax_mode():
                ra = js.decode(codes)
            ga = ps.decode(codes)
            assert ga.dtype == np.float32 and ga.shape == ra.shape
            assert _rel(ga, ra) < _AUDIO_TOL
    for s in (js, ps):
        s.reset()
    audio = (rng.normal(size=(2, fs)) * 0.1).astype(np.float32)
    with _jax_mode():
        ref = js.encode(audio)
    np.testing.assert_array_equal(ps.encode(audio), ref)


def test_voice_prefix_from_the_streamer_matches_jax(mimi):
    """``make_voice_prefix`` fed by each package's MimiStreamer.encode: the
    same text and audio prefixes from 3.5 frames of audio (the half frame
    dropped)."""
    js, ps = mimi()
    fs = 1920
    rng = np.random.default_rng(2)
    audio = (rng.normal(size=(int(3.5 * fs),)) * 0.1).astype(np.float32)
    cfg = JaxLMConfig(**_TTS)

    def jax_encode(x):
        with _jax_mode():
            return js.encode(x)

    ref = jax_voice_prefix(jax_encode, audio, cfg, cfg.delay_steps)
    got = make_voice_prefix(ps.encode, audio, LMConfig(**_TTS),
                            _TTS["delay_steps"])
    assert got == ref
    text, prefixes = got
    assert len(text) == 3
    assert len(prefixes) == cfg.max_delay + cfg.delay_steps + 3
