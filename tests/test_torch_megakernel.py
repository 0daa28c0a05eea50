"""The port's LM frame step under ``MOSHI_TPU_MEGAKERNEL`` against the JAX
package's, on the CPU: the whole ``lm_gen_step`` with the temporal
megakernel (K13, on the flat ring layout ``init_gen_state`` picks from
the weights), the depformer frame kernel (K14c) or the step megakernel
(K14a), and ``STSPipeline`` under ``all``.

JAX runs with its Pallas kernels in interpret mode; the port runs each
kernel's plain version.  The knob is read when JAX traces, so its caches
are cleared between settings.  At temp > 0 both packages sample from
JAX's Gumbel noise: the draws of its ``sample_token`` (over the top-k
values) and of its frame kernel (over the card) are recorded and fed to
the port's samplers in the same order (those runs, the STS frame and the
TTS frame are in ``test_torch_megakernel_frames.py``).

The configuration mirrors the 7B's dispatch (every projection q4_k, the
depformer linear_out q4_0, card a multiple of 128, a ring of dep_q
slots); a card of 192 takes the depformer off the frame kernel onto
K14a.  The temporal ring holds 16 positions, so 22 frames wrap it.

Limits: transformer_out within ``_H_TOL`` = 1e-5 of its largest value
where the temporal stack is K13 (the dequant arithmetic: sound readings
2.3e-7 at temp 0 and up to 2.4e-6 at temp > 0 over 22 frames; control:
the K13 controls of ``test_torch_temporal.py``, 2.5e-5 and above on one
step), within ``_RTOL`` = 2e-3 where it is the stacked int8 path
(``test_torch_lm.py``'s limit: a last-bit difference flips an int8
activation rounding; read 4.4e-6 here); every sampled token equal wherever its top-1/top-2
margin (``_margin``) exceeds ``_RTOL`` of the largest logit.  At temp > 0
``sample_token`` adds its noise by rank, so a swap of any two kept
logits changes the token: there the margin must exceed four times that
call's own distance between the two packages' logits (recorded on both
sides).  Comparison stops at the first token that differs within its
margin, and at least 20 frames must be compared.
"""

import collections
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
import moshi_tpu.nn.pallas_depformer as jax_dep
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.lm import init_gen_state as jax_init_gen_state
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn import depformer as port_dep
from moshi_tpu_torch.nn import temporal as port_temporal
from moshi_tpu_torch.runtime.convert import (gen_state_from_numpy,
                                             params_from_numpy)
from test_torch_lm import export_numpy

_KW = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
           card=256, n_q=8, dep_q=4, text_card=512,
           delays=(0, 0, 1, 1, 2, 0, 1, 1, 2), depformer_dim=256,
           depformer_heads=4, depformer_layers=2, depformer_hidden=576,
           depformer_low_rank=32)
_FRAMES = 22
_RTOL = 2e-3
_H_TOL = 1e-5
_TEMPS = {"greedy": (0.0, 0.0), "sampled": (0.8, 0.7)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread
    hand-offs than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _margin(logits, temp, top_k, noise, by_rank):
    """How far the sampler's choice is from changing, relative to the
    largest |logit / temp|: at temp 0 the top-1 minus top-2 logit.  At
    temp > 0 also the k-th minus the (k+1)-th scaled logit (the cut of the
    kept set), and, where the noise follows the values' rank (``by_rank``:
    ``sample_token``'s noise over the top-k values in order), every gap
    between neighbours among the kept values, since two that swap places
    swap their noise; where it follows the token id (the frame kernel's
    noise over the whole card), the top-1 minus top-2 of the kept values
    plus their noise."""
    if temp == 0.0:
        top2 = np.sort(logits)[-2:]
        return (top2[1] - top2[0]) / np.max(np.abs(logits))
    scaled = logits.astype(np.float32) / temp
    k = min(top_k, scaled.size) if top_k > 0 else scaled.size
    desc = np.sort(scaled)[::-1]
    gaps = [np.inf] if k == desc.size else [desc[k - 1] - desc[k]]
    if by_rank:
        gaps.append(np.min(np.diff(-desc[:k]), initial=np.inf))
        score = desc[:k] + noise
    else:
        score = np.where(scaled >= desc[k - 1], scaled + noise, -np.inf)
    top2 = np.sort(score)[-2:]
    gaps.append(top2[1] - top2[0])
    return min(gaps) / np.max(np.abs(scaled))


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _run_jax(cfg, params, other, knob, temp, temp_text):
    """JAX's frames, jitted as one program: the sampled text and audio
    tokens, transformer_out, and every sampler's noise in call order."""
    rec = collections.defaultdict(list)
    orig_sample, orig_frame = jax_lm.sample_token, jax_dep.dep_frame_step
    orig_gen = jax_lm.depformer_generate

    def log(name, x):
        jax.debug.callback(lambda v: rec[name].append(np.array(v)), x,
                           ordered=True)

    def sample(logits, key, t, top_k):
        log("logits", logits)
        if t > 0:
            v = logits.shape[-1]
            k = min(int(top_k), v) if top_k > 0 else v
            log("noise", jax.random.gumbel(key, logits.shape[:-1] + (k,),
                                           jnp.float32))
        return orig_sample(logits, key, t, top_k)

    def frame(h_in_all, text_emb, weights, noise, **kw):
        log("frame_noise", noise)
        return orig_frame(h_in_all, text_emb, weights, noise, **kw)

    @functools.wraps(orig_gen)
    def generate(*a, **kw):
        toks = orig_gen(*a, **kw)
        log("audio", toks)
        return toks

    def step(p, s, o):
        text, h, s = jax_lm.lm_text_step(cfg, p, s, other_audio=o,
                                         temp_text=temp_text)
        out, s = jax_lm.lm_audio_step(cfg, p, s, text, h, temp=temp)
        return out, s, h

    outs, hs = [], []
    old = os.environ.get("MOSHI_TPU_MEGAKERNEL")
    os.environ["MOSHI_TPU_MEGAKERNEL"] = knob
    jax.clear_caches()
    jax_lm.sample_token, jax_dep.dep_frame_step = sample, frame
    jax_lm.depformer_generate = generate
    enable_pallas(True)
    try:
        with pallas_interpret():
            state = jax_init_gen_state(cfg, 1, jax.random.PRNGKey(5),
                                       params=params)
            state0 = jax.tree_util.tree_map(np.asarray, state)
            jstep = jax.jit(step)
            for f in range(len(other)):
                out, state, h = jstep(params, state, jnp.asarray(other[f]))
                outs.append({k: np.asarray(v) for k, v in out.items()})
                hs.append(np.asarray(h))
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token, jax_dep.dep_frame_step = orig_sample, orig_frame
        jax_lm.depformer_generate = orig_gen
        if old is None:
            os.environ.pop("MOSHI_TPU_MEGAKERNEL", None)
        else:
            os.environ["MOSHI_TPU_MEGAKERNEL"] = old
        jax.clear_caches()
    return dict(out=outs, h=hs, audio=rec["audio"], noise=rec["noise"],
                frame_noise=rec["frame_noise"], logits=rec["logits"],
                state0=state0)


def _run_port(cfg, params, other, knob, temp, temp_text, ref):
    """The port's frames from the JAX package's initial state, fed JAX's
    noise; per frame its transformer_out, outputs, generated audio tokens
    and the margin of every sampled token (text first)."""
    noise = collections.deque(ref["noise"])
    frame_noise = collections.deque(ref["frame_noise"])
    jax_logits = collections.deque(ref["logits"])
    frames, margins, taps = [], [], {}
    orig = dict(tf=port_lm.temporal_forward, sample=port_lm.sample_token,
                gumbel=port_lm.gumbel, scaled=port_dep.sample_scaled,
                gen=port_lm.depformer_generate)

    def tf(*a, **kw):
        h, logits, kv = orig["tf"](*a, **kw)
        taps["h"] = h[:, -1].numpy().copy()
        return h, logits, kv

    def sample(logits, t, top_k, generator=None, noise_in=None):
        nz = torch.from_numpy(noise.popleft()) if t > 0 else None
        mine, theirs = logits.numpy()[0], jax_logits.popleft()[0]
        margin = _margin(mine, t, top_k, None if nz is None else
                         nz.numpy()[0], by_rank=True)
        if t > 0:
            # the rank-ordered noise turns any neighbour swap into another
            # token: hold it against this call's own distance from JAX
            margin *= _RTOL / max(4 * _rel(mine, theirs), 1e-6)
        margins.append(margin)
        return orig["sample"](logits, t, top_k, generator, noise=nz)

    def scaled(logits, nz, t, top_k, card):
        margins.append(_margin(logits.numpy(), t, top_k, nz.numpy(),
                               by_rank=False))
        return orig["scaled"](logits, nz, t, top_k, card)

    def generate(*a, **kw):
        toks = orig["gen"](*a, **kw)
        taps["audio"] = toks.numpy().copy()
        return toks

    old = os.environ.get("MOSHI_TPU_MEGAKERNEL")
    os.environ["MOSHI_TPU_MEGAKERNEL"] = knob
    port_lm.temporal_forward, port_lm.sample_token = tf, sample
    port_lm.gumbel = lambda shape, generator=None, device=None: \
        torch.from_numpy(frame_noise.popleft())
    port_dep.sample_scaled = scaled
    port_lm.depformer_generate = generate
    try:
        state = gen_state_from_numpy(ref["state0"], device="cpu")
        fresh = port_lm.init_gen_state(cfg, 1, device="cpu", params=params)
        assert state["transformer"]["k"].shape == \
            fresh["transformer"]["k"].shape
        for f in range(len(other)):
            margins.clear()
            out, state = port_lm.lm_gen_step(
                cfg, params, state, other_audio=torch.from_numpy(other[f]),
                temp=temp, temp_text=temp_text)
            frames.append(dict(out={k: v.numpy() for k, v in out.items()},
                               margins=list(margins), **taps))
    finally:
        port_lm.temporal_forward = orig["tf"]
        port_lm.sample_token, port_lm.gumbel = orig["sample"], orig["gumbel"]
        port_dep.sample_scaled = orig["scaled"]
        port_lm.depformer_generate = orig["gen"]
        if old is None:
            os.environ.pop("MOSHI_TPU_MEGAKERNEL", None)
        else:
            os.environ["MOSHI_TPU_MEGAKERNEL"] = old
    return frames


_CASES = {"temporal": ("temporal", {}), "dep": ("dep", {}),
          "all": ("all", {}), "dep-k14a": ("dep", dict(card=192)),
          "all-k14a": ("all", dict(card=192))}
# At temp > 0 the rank-ordered noise of ``sample_token`` turns a swap of
# any two kept logits into another token, so the streams are compared
# where the logits that it samples agree to f32 rounding: under "all"
# (K13, and the depformer on the dequant arithmetic from an f32 carry).
# Where the int8 stacked stack feeds the text head or the depformer
# (~1e-3 apart, test_torch_lm.py), sampled streams part within a few
# frames for that reason alone, and are compared at temp 0.
_SAMPLED = ("all", "all-k14a")
_RUNS = {}


def _runs(case, temps):
    """(JAX frames, port frames, port config, K13/K14 calls) per case and
    temperature, made once per module."""
    if (case, temps) not in _RUNS:
        knob, over = _CASES[case]
        kw = {**_KW, **over}
        cfg = JaxLMConfig(**kw)
        params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
        rng = np.random.default_rng(7)
        other = rng.integers(0, cfg.card, (_FRAMES, 1, cfg.n_q - cfg.dep_q),
                             dtype=np.int32)
        temp, temp_text = _TEMPS[temps]
        ref = _run_jax(cfg, params, other, knob, temp, temp_text)
        pcfg = port_lm.LMConfig(**kw)
        pparams = params_from_numpy(export_numpy(params), device="cpu")
        calls = collections.Counter()
        spies = {n: getattr(m, n) for m, n in (
            (port_temporal, "temporal_full_step_plain"),
            (port_dep, "dep_full_step_plain"),
            (port_dep, "dep_frame_step_plain"))}

        def spy(name):
            def run(*a, **k):
                calls[name] += 1
                return spies[name](*a, **k)
            return run

        port_temporal.temporal_full_step_plain = spy(
            "temporal_full_step_plain")
        port_dep.dep_full_step_plain = spy("dep_full_step_plain")
        port_dep.dep_frame_step_plain = spy("dep_frame_step_plain")
        try:
            got = _run_port(pcfg, pparams, other, knob, temp, temp_text, ref)
        finally:
            port_temporal.temporal_full_step_plain = spies[
                "temporal_full_step_plain"]
            port_dep.dep_full_step_plain = spies["dep_full_step_plain"]
            port_dep.dep_frame_step_plain = spies["dep_frame_step_plain"]
        _RUNS[case, temps] = (ref, got, pcfg, calls)
    return _RUNS[case, temps]


def _compared(ref, got):
    """Frames before the first token that differs within its margin."""
    for f, g in enumerate(got):
        tokens = np.concatenate([ref["out"][f]["sampled_text"].ravel(),
                                 ref["audio"][f].ravel()])
        mine = np.concatenate([g["out"]["sampled_text"].ravel(),
                               g["audio"].ravel()])
        close = np.asarray(g["margins"]) <= _RTOL
        if np.any((tokens != mine) & close):
            return f
    return len(got)


def check_lm_step(case, temps):
    """The port's frames against JAX's in one case (see the module
    docstring for the limits), and the path each knob selects."""
    ref, got, cfg, calls = _runs(case, temps)
    knob = _CASES[case][0]
    n = _compared(ref, got)
    assert n >= 20, f"token streams diverged at frame {n}"
    h_tol = _H_TOL if knob in ("temporal", "all") else _RTOL
    decided = 0
    for f in range(n):
        err = (np.max(np.abs(got[f]["h"] - ref["h"][f]))
               / np.max(np.abs(ref["h"][f])))
        assert err < h_tol, (f, err)
        tokens = np.concatenate([ref["out"][f]["sampled_text"].ravel(),
                                 ref["audio"][f].ravel()])
        mine = np.concatenate([got[f]["out"]["sampled_text"].ravel(),
                               got[f]["audio"].ravel()])
        sure = np.asarray(got[f]["margins"]) > _RTOL
        np.testing.assert_array_equal(mine[sure], tokens[sure])
        decided += int(sure.sum())
        for key in ("text", "audio", "valid"):
            np.testing.assert_array_equal(got[f]["out"][key],
                                          ref["out"][f][key])
    # at temp > 0 K14a's logits pass K1, whose int8 roundings (and ties
    # among their discrete values) leave many neighbour gaps of its 192
    # rank-noised values within the margin: half must still be decided
    share = 0.9 if temps == "greedy" else 0.5
    assert decided >= n * (1 + cfg.dep_q) * share, decided
    # the path each knob selects, in the port: K13 once per frame under
    # temporal/all; K14c once per frame, or K14a once per step
    per_frame = {"temporal_full_step_plain": knob in ("temporal", "all"),
                 "dep_frame_step_plain": knob in ("dep", "all")
                 and not case.endswith("k14a"),
                 "dep_full_step_plain": case.endswith("k14a") and cfg.dep_q}
    for name, k in per_frame.items():
        assert calls[name] == int(k) * _FRAMES, (name, calls)


@pytest.mark.parametrize("case", [c for c in _CASES if c != "all-k14a"])
def test_lm_step_under_megakernel_matches_jax(case):
    check_lm_step(case, "greedy")


def test_megakernel_knob_off_keeps_todays_path(monkeypatch):
    """Without the knob the weights leave the layout and the launches as
    they were: the stacked rings, and none of K13/K14."""
    monkeypatch.delenv("MOSHI_TPU_MEGAKERNEL", raising=False)
    cfg = port_lm.LMConfig(**_KW)
    params = params_from_numpy(export_numpy(jax_synth_lm_params(
        jax.random.PRNGKey(3), JaxLMConfig(**_KW), fmt="q4_k")),
        device="cpu")
    state = port_lm.init_gen_state(cfg, 1, device="cpu", params=params)
    assert state["transformer"]["k"].dim() == 5
    build.COUNTS.clear()
    called = []
    for mod, name in ((port_temporal, "temporal_full_step_plain"),
                      (port_dep, "dep_full_step_plain"),
                      (port_dep, "dep_frame_step_plain")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: called.append(_n))
    port_lm.lm_gen_step(cfg, params, state, temp=0.0, temp_text=0.0)
    assert called == []


def test_k14a_short_ring_differs_from_the_xla_depformer(monkeypatch):
    """With fewer ring slots than steps (cap 2 < dep_q 4) the step
    megakernel, like the JAX package's dep_full_step, writes no row at
    steps >= cap, while the generic (XLA) depformer wraps to slot
    cb % cap: the two agree on the steps before cap and not after (a
    fault of the reference, ROADMAP.md C)."""
    kw = {**_KW, "depformer_context": 2}
    cfg = port_lm.LMConfig(**kw)
    params = params_from_numpy(export_numpy(jax_synth_lm_params(
        jax.random.PRNGKey(3), JaxLMConfig(**kw), fmt="q4_k")),
        device="cpu")
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32))
    text = torch.tensor([3])
    logged = {}

    def logits_of(knob):
        monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", knob)
        rows = []
        orig = port_lm.sample_token
        monkeypatch.setattr(port_lm, "sample_token", lambda lg, *a, **k: (
            rows.append(lg.numpy()[0]), orig(lg, *a, **k))[1])
        dep = params["depformer"]
        sw = port_lm._per_step_weights(cfg, dep)
        logged[knob] = (port_lm._can_use_dep_megakernel(cfg, dep, 1),
                        port_lm._can_use_dep_frame_kernel(cfg, dep, sw, 1))
        port_lm.depformer_generate(cfg, params, h, text, 0.0, 250)
        monkeypatch.setattr(port_lm, "sample_token", orig)
        return np.stack(rows)

    mega, xla = logits_of("dep"), logits_of("")
    assert logged == {"dep": (True, False), "": (False, False)}
    scale = np.max(np.abs(xla))
    diff = np.max(np.abs(mega - xla), axis=-1) / scale
    # steps 0-1: the same attention, the logits apart by the two forms'
    # arithmetic (dequant against int8: 1.2e-4 to 1.5e-4); steps 2-3:
    # another attention (7.9e-3 to 8.8e-3)
    assert np.all(diff[:2] < 1e-3) and np.all(diff[2:] > 4e-3), diff
