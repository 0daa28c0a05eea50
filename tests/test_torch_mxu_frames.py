"""The port's frames under the K10 and K12 knobs against the JAX
package's, on the CPU: the whole ``lm_gen_step`` under "sts_mxu"
(``MOSHI_TPU_ATTN_MXU=1`` with ``MOSHI_TPU_KSEG=1``) and under
"lm_split" (``MOSHI_TPU_ATTN_MXU=1`` with ``MOSHI_TPU_SPLIT_SPREAD=1``),
and ``STSPipeline.step`` under "sts_mxu", at temp 0.

The configuration reaches both kernels as the 7B does: the temporal
heads have hd 128 (H * hd = 256) over a 48-slot ring, where K10's chunk
is 24 and K3's 16; the temporal linear_out has K = 5120 (q4_k, nb 160 >
128, K/2 a multiple of 512: two segments, the last short), so it takes
K12; every other product keeps its kernel; the depformer's heads have hd
64 over its ring of dep_q slots (K10 with one chunk).  56 frames wrap
the temporal ring.  JAX runs its Pallas kernels in interpret mode (its
knobs are read when it traces, so its caches are cleared around each
run); the port runs each kernel's plain version.

Limits: transformer_out within ``_H_TOL`` = 1e-4 of its largest value;
the text and depformer logits within ``test_torch_lm.py``'s 2e-3 (a
last-bit difference flips an int8 activation rounding, or a bf16
rounding of K10's p . v, and the logits carry it), every token equal
where its top-1 / top-2 gap exceeds that, and the delay cache's outputs
exact.  Readings over 56 frames, the same in both settings:
transformer_out 1.7e-5, the text logits 3.2e-4, the depformer's 6.4e-4;
165 of 168 tokens decided, all alike.  Control: the port on K3 (its knob
off) against JAX on K10 moves transformer_out by 1.0e-4 to 1.8e-4 from
the third frame on.  K12's forms differ from K1 in the f32 order of a
sum alone, which no frame reading can tell apart (its kernel tests hold
it).
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

import moshi_tpu.nn.pallas_attention as jpa
import moshi_tpu.quant.pallas_matmul_int8 as jmi
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn import decode_attention as pda
from moshi_tpu_torch.quant import matmul_int8 as pmi
from moshi_tpu_torch.runtime.convert import params_from_numpy
import test_torch_lm as tl

_KW = dict(dim=256, num_heads=2, num_layers=2, hidden_dim=5120, context=48,
           card=256, n_q=4, dep_q=2, text_card=512, delays=(0, 0, 1, 1, 2),
           depformer_dim=256, depformer_heads=4, depformer_layers=2,
           depformer_hidden=576, depformer_low_rank=32)
_FRAMES = 56
_H_TOL = 1e-4
_SETTINGS = {
    "sts_mxu": {"MOSHI_TPU_ATTN_MXU": "1", "MOSHI_TPU_KSEG": "1",
                "MOSHI_TPU_SPLIT_SPREAD": "0"},
    "lm_split": {"MOSHI_TPU_ATTN_MXU": "1", "MOSHI_TPU_KSEG": "0",
                 "MOSHI_TPU_SPLIT_SPREAD": "1"},
}
_K12 = {"sts_mxu": "int8_matvec_kseg_plain",
        "lm_split": "int8_matvec_split_plain"}
_K12_JAX = {"sts_mxu": "_mk_kernel_kseg", "lm_split": "_mk_kernel_split"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread
    hand-offs than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Env:
    """The knobs of one setting in the environment, restored after."""

    def __init__(self, setting):
        self.values = _SETTINGS[setting]

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        jax.clear_caches()

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax.clear_caches()


def _counted(module, name, calls):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def counted(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **kw)

    setattr(module, name, counted)
    return fn


_RUNS = {}


def _runs(setting):
    """(JAX frames, port frames, port calls, JAX kernel traces) for one
    knob setting, made once per module."""
    if setting not in _RUNS:
        cfg = JaxLMConfig(**_KW)
        params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
        rng = np.random.default_rng(7)
        other = rng.integers(0, cfg.card, (_FRAMES, 1, cfg.n_q - cfg.dep_q),
                             dtype=np.int32)
        traced, calls = {}, {}
        spied = [(jpa, "_decode_attn_kernel_stacked_mxu", traced),
                 (jmi, _K12_JAX[setting], traced),
                 (pda, "decode_attention_mxu_plain", calls),
                 (pda, "decode_attention_plain", calls),
                 (pmi, _K12[setting], calls),
                 (pmi, "int8_matvec_plain", calls)]
        saved = [(m, n, _counted(m, n, box)) for m, n, box in spied]
        try:
            with _Env(setting):
                ref, _ = tl._run_jax(cfg, params, other, "1")
                pparams = params_from_numpy(tl.export_numpy(params),
                                            device="cpu")
                got, _ = tl._run_port(port_lm.LMConfig(**_KW), pparams,
                                      other, "1")
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)
        _RUNS[setting] = dict(ref=ref, got=got, calls=calls, traced=traced,
                              params=pparams, other=other)
    return _RUNS[setting]


@pytest.fixture(scope="module", params=list(_SETTINGS))
def runs(request):
    return request.param, _runs(request.param)


def test_frames_take_k10_and_k12(runs):
    """Per frame: K10 in every temporal layer and depformer step-layer, no
    K3; K12 in every temporal linear_out; in JAX the MXU attention and the
    setting's K12 form are traced."""
    setting, r = runs
    cfg = port_lm.LMConfig(**_KW)
    t, d = cfg.num_layers, cfg.dep_q * cfg.depformer_layers
    assert r["calls"]["decode_attention_mxu_plain"] == (t + d) * _FRAMES
    assert "decode_attention_plain" not in r["calls"]
    assert r["calls"][_K12[setting]] == t * _FRAMES
    assert r["calls"]["int8_matvec_plain"] > 0        # the other products
    assert r["traced"]["_decode_attn_kernel_stacked_mxu"] >= 2
    assert r["traced"][_K12_JAX[setting]] >= 1


def test_frames_match_jax(runs):
    _, r = runs
    ref, got = r["ref"], r["got"]
    n = tl._compared_frames(ref, got)
    assert n == _FRAMES, f"token streams diverged at frame {n}"
    for f in range(n):
        assert tl._rel_err(got[f]["h"], ref[f]["h"]) < _H_TOL, f
        assert tl._rel_err(got[f]["logits"], ref[f]["logits"]) < tl._RTOL, f
        assert tl._rel_err(got[f]["dep_logits"],
                           ref[f]["dep_logits"]) < tl._RTOL, f


def test_k3_control_fails_the_limit(monkeypatch):
    """The port on K3 (``MOSHI_TPU_ATTN_MXU=0``) against JAX on K10: the
    attention's roundings move transformer_out past ``_H_TOL``."""
    r = _runs("sts_mxu")
    monkeypatch.setenv("MOSHI_TPU_ATTN_MXU", "0")
    ctl, _ = tl._run_port(port_lm.LMConfig(**_KW), r["params"], r["other"],
                          "1")
    n = tl._compared_frames(r["ref"], ctl)
    assert n >= 20
    worst = max(tl._rel_err(ctl[f]["h"], r["ref"][f]["h"]) for f in range(n))
    assert worst > _H_TOL, worst


def test_tokens_match_where_decided(runs):
    _, r = runs
    ref, got = r["ref"], r["got"]
    checked = 0
    for f in range(_FRAMES):
        decided = tl._gap(ref[f]["logits"]) > tl._RTOL
        np.testing.assert_array_equal(
            got[f]["out"]["sampled_text"][decided],
            ref[f]["out"]["sampled_text"][decided])
        dep_decided = tl._gap(ref[f]["dep_logits"]) > tl._RTOL
        np.testing.assert_array_equal(
            got[f]["gen_audio"][dep_decided],
            np.argmax(ref[f]["dep_logits"], -1)[dep_decided])
        checked += int(decided.sum()) + int(dep_decided.sum())
        for key in ("text", "audio", "valid"):
            np.testing.assert_array_equal(got[f]["out"][key],
                                          ref[f]["out"][key])
    assert checked >= _FRAMES * 2


def test_sts_pipeline_under_sts_mxu_matches_jax(monkeypatch):
    """``STSPipeline.step`` under "sts_mxu" at temp 0 (Mimi encode, the LM
    frame through K10 and K12, Mimi decode) on ``test_torch_pipeline.py``'s
    Mimi, with card 64 to index its codebooks: the same checks as that
    test, and K10 and K12 taken."""
    import test_torch_pipeline as tp
    from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
    from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
    from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
    kw = {**_KW, "card": 64}
    monkeypatch.setattr(tp, "_LM", kw)
    cfg = JaxLMConfig(**kw)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**tp._SEANET), **tp._MIMI)
    lm_params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
    mimi_params = tp._mimi_params(JaxMimiModel(mcfg), 4)
    rng = np.random.default_rng(5)
    fs = mcfg.seanet.hop_length * mcfg.frames_per_step
    audio = [(rng.normal(size=(1, fs)) * 0.1).astype(np.float32)
             for _ in range(tp._FRAMES)]
    calls = {}
    saved = [(m, n, _counted(m, n, calls)) for m, n in (
        (pda, "decode_attention_mxu_plain"), (pmi, _K12["sts_mxu"]))]
    try:
        with _Env("sts_mxu"):
            ref = tp._run_jax(cfg, mcfg, lm_params, mimi_params, audio)
            got = tp._run_port(params_from_numpy(tp._np(lm_params),
                                                 device="cpu"),
                               params_from_numpy(tp._np(mimi_params),
                                                 device="cpu"), audio)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    pcfg = port_lm.LMConfig(**kw)
    assert calls["decode_attention_mxu_plain"] == tp._FRAMES * (
        pcfg.num_layers + pcfg.dep_q * pcfg.depformer_layers)
    assert calls[_K12["sts_mxu"]] == tp._FRAMES * pcfg.num_layers
    n = tp._compared(ref, got)
    assert n == tp._FRAMES, f"token streams diverged at frame {n}"
    for f in range(n):
        np.testing.assert_array_equal(got[f]["codes"], ref[f]["codes"])
        for key in ("logits", "dep_logits"):
            decided = tp._gap(ref[f][key]) > tp._RTOL
            np.testing.assert_array_equal(
                np.argmax(got[f][key], -1)[decided],
                np.argmax(ref[f][key], -1)[decided])
        for key in ("text", "audio_tokens", "valid"):
            np.testing.assert_array_equal(got[f][key], ref[f][key])
        a, b = got[f]["audio_out"], ref[f]["audio_out"]
        assert np.all(np.isfinite(a))
        assert np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30) < \
            tp._AUDIO_TOL, f
