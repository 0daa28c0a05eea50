"""The port's tensor-parallel frame (``moshi_tpu_torch/parallel/tp.py``)
against the JAX package's ``tp_scope`` frame, on the same q4_k and q8_0
weights, on the CPU; and the GSPMD-style frame (``parallel/sharding.py``)
against the single-rank frame.

The port's ranks are threads of this process, each with its own gloo
groups (``parallel/mesh.py`` ``in_process_mesh``) and its own scope; the
JAX package runs its shard_map frames on the conftest's 8 CPU devices with
Pallas in interpret mode.  Two frames at temp 0; the text logits and
transformer_out held to 0.2% of their largest magnitude (the plain
versions against the interpreter, as ``test_torch_lm.py`` holds the
single-rank frame), the tokens equal where JAX's top-1/top-2 gap clears
that, the audio tokens equal.

The tiny configuration routes every shard as the 7B's does: each column
shard (out_proj's and linear_out's K = 256 a rank, the depformer's
out_proj too) keeps the int8 matvec, whose rule needs (K / 32) % 8 == 0,
and the depformer's q4_0 linear_out (640, 320 a rank) stays on the
dequant matvec, as the 7B's 4224 (2112 a rank) does.  At narrower shards the JAX package, whose QuantTensor keeps
its global shape inside shard_map, and the port, whose shards carry
theirs, would route them apart.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import moshi_tpu.models.lm as jax_lm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.lm import init_gen_state as jax_init_gen_state
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.parallel import mesh as port_mesh
from moshi_tpu_torch.parallel import sharding, tp
from moshi_tpu_torch.quant.formats import int8_dispatch
from moshi_tpu_torch.runtime.convert import params_from_numpy
from test_torch_lm import _gap, _rel_err, export_numpy

KW = dict(dim=512, num_heads=4, num_layers=2, hidden_dim=512, context=16,
          card=256, n_q=4, dep_q=2, text_card=512, delays=(0, 0, 1, 1, 2),
          depformer_dim=512, depformer_heads=4, depformer_layers=2,
          depformer_hidden=640, depformer_low_rank=32)
FRAMES = 2
RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the ranks are threads, and these tiny ops lose
    more to thread hand-offs than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(n: int, fn):
    """``fn(rank, store)`` on ``n`` threads at once (each builds its own
    groups over the shared ``store``); {rank: result}, raising the first
    rank's error."""
    store = dist.HashStore()
    res, errs = {}, []

    def work(r):
        try:
            res[r] = fn(r, store)
        except BaseException as e:        # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return res


def other_audio(cfg, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.card, (FRAMES, batch, cfg.n_q - cfg.dep_q),
                        dtype=np.int32)


def run_jax(cfg, params, state, others):
    """JAX's frames (jitted, Pallas interpreted) under whatever scope is
    active: per frame the sampled text, the audio output, transformer_out
    and the sampled text logits (taken from ``sample_token``'s argument
    outside any shard_map)."""
    taken = []
    orig = jax_lm.sample_token

    def sample(logits, *a, **kw):
        taken.append(logits)
        return orig(logits, *a, **kw)

    def step(p, s, o):
        taken.clear()
        text, h, s = jax_lm.lm_text_step(cfg, p, s, other_audio=o,
                                         temp_text=0.0)
        logits = taken[0]
        out, s = jax_lm.lm_audio_step(cfg, p, s, text, h, temp=0.0)
        return out, s, h, logits

    jax_lm.sample_token = sample
    enable_pallas(True)
    try:
        f = jax.jit(step)
        frames = []
        for o in others:
            with pallas_interpret():
                out, state, h, logits = f(params, state, jnp.asarray(o))
            frames.append({"text": np.asarray(out["sampled_text"]),
                           "audio": np.asarray(out["audio"]),
                           "h": np.asarray(h, np.float32),
                           "logits": np.asarray(logits)})
    finally:
        jax_lm.sample_token = orig
        enable_pallas(False)
    return frames


_LOGITS = threading.local()


@pytest.fixture(autouse=True)
def _recorded_logits(monkeypatch):
    """The port's ``sample_token`` records each call's logits on the
    calling rank's thread (its first call a frame: the text logits)."""
    orig = port_lm.sample_token

    def sample(logits, *a, **kw):
        got = getattr(_LOGITS, "taken", None)
        if got is not None:
            got.append(logits.detach().float().clone())
        return orig(logits, *a, **kw)

    monkeypatch.setattr(port_lm, "sample_token", sample)


def run_port(cfg, params, state, others, rows=slice(None)):
    """The port's frames for this rank's ``rows`` of the batch, as
    ``run_jax`` reports them."""
    frames = []
    for o in others:
        _LOGITS.taken = []
        text, h, state = port_lm.lm_text_step(
            cfg, params, state, other_audio=torch.from_numpy(o[rows]),
            temp_text=0.0)
        out, state = port_lm.lm_audio_step(cfg, params, state, text, h,
                                           temp=0.0)
        frames.append({"text": out["sampled_text"].numpy(),
                       "audio": out["audio"].numpy(),
                       "h": h.float().numpy(),
                       "logits": _LOGITS.taken[0].numpy()})
    _LOGITS.taken = None
    return frames, state


def joined(per_rank, ranks):
    """Each frame's fields, the given ranks' rows concatenated in order."""
    return [{k: np.concatenate([per_rank[r][f][k] for r in ranks])
             for k in per_rank[ranks[0]][f]}
            for f in range(len(per_rank[ranks[0]]))]


def assert_frames_match(got, ref):
    """Tokens equal (text where JAX's gap clears RTOL), transformer_out
    and the text logits within RTOL of their largest magnitude."""
    for f, (g, r) in enumerate(zip(got, ref)):
        assert _rel_err(g["h"], r["h"]) < RTOL, f
        assert _rel_err(g["logits"], r["logits"]) < RTOL, f
        decided = _gap(r["logits"]) > RTOL
        assert decided.any(), f
        np.testing.assert_array_equal(g["text"][decided], r["text"][decided])
        np.testing.assert_array_equal(g["audio"], r["audio"], err_msg=str(f))


_CASES = {}


def tp_case(fmt: str, data: int, model: int, batch: int):
    """({rank: (port frames, collective counts)}, JAX frames, the port's
    single-rank frames, the port's whole params), made once per module."""
    key = (fmt, data, model, batch)
    if key in _CASES:
        return _CASES[key]
    from moshi_tpu.parallel import (lm_state_pspecs as jax_state_pspecs,
                                    make_mesh as jax_make_mesh,
                                    shard_tree as jax_shard_tree,
                                    tp_scope as jax_tp_scope,
                                    tp_shard_lm_params as jax_tp_shard)
    jcfg = JaxLMConfig(**KW)
    jparams = jax_synth_lm_params(jax.random.PRNGKey(0), jcfg, fmt=fmt)
    others = other_audio(jcfg, batch)
    jmesh = jax_make_mesh(data=data, model=model)
    jstate = jax_init_gen_state(jcfg, batch, jax.random.PRNGKey(5))
    jstate = jax_shard_tree(jstate, jax_state_pspecs(jstate), jmesh)
    with jax_tp_scope(jmesh):
        ref = run_jax(jcfg, jax_tp_shard(jparams, jcfg, jmesh), jstate,
                      others)
    cfg = port_lm.LMConfig(**KW)
    params = params_from_numpy(export_numpy(jparams), device="cpu")

    def rank(r, store):
        mesh = port_mesh.in_process_mesh(("data", "model"), (data, model),
                                         r, store)
        local = tp.tp_shard_lm_params(params, cfg, mesh)
        state = port_lm.init_gen_state(cfg, batch, device="cpu")
        state = sharding.shard_tree(state, sharding.lm_state_pspecs(state),
                                    mesh)
        per = batch // data
        i = mesh.index("data")
        with tp.tp_scope(mesh):
            frames, _ = run_port(cfg, local, state, others,
                                 slice(i * per, (i + 1) * per))
        return frames, dict(mesh.counts)

    got = run_ranks(data * model, rank)
    single, _ = run_port(cfg, params,
                         port_lm.init_gen_state(cfg, batch, device="cpu"),
                         others)
    _CASES[key] = (got, ref, single, params)
    return _CASES[key]


_TP = [("q4_k", 1, 2, 1), ("q8_0", 2, 2, 2)]


@pytest.mark.parametrize("fmt,data,model,batch", _TP,
                         ids=[f"{c[0]}-d{c[1]}m{c[2]}" for c in _TP])
def test_tp_frame_matches_jax(fmt, data, model, batch):
    got, ref, _, _ = tp_case(fmt, data, model, batch)
    # the ranks of a model group hold the same rows, bit for bit
    for d in range(data):
        group = [d * model + m for m in range(model)]
        for r in group[1:]:
            for a, b in zip(got[r][0], got[group[0]][0]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    firsts = [d * model for d in range(data)]
    assert_frames_match(joined({r: got[r][0] for r in firsts}, firsts), ref)


@pytest.mark.parametrize("fmt,data,model,batch", _TP,
                         ids=[f"{c[0]}-d{c[1]}m{c[2]}" for c in _TP])
def test_tp_collectives_per_frame(fmt, data, model, batch):
    """Per rank and frame: two psums a temporal layer, two a depformer
    layer and step, and the text logits and each step's logits gathered."""
    got, _, _, _ = tp_case(fmt, data, model, batch)
    cfg = port_lm.LMConfig(**KW)
    psums = 2 * cfg.num_layers + 2 * cfg.depformer_layers * cfg.dep_q
    for r, (_, counts) in got.items():
        assert counts == {"psum": psums * FRAMES,
                          "all_gather": (1 + cfg.dep_q) * FRAMES}, r


def test_tp_shards_keep_the_int8_route():
    """Every column shard still takes the int8 matvec at one row, and the
    depformer's q4_0 linear_out shard the dequant matvec, as whole."""
    _, _, _, params = tp_case(*_TP[0])
    cfg = port_lm.LMConfig(**KW)

    def rank(r, store):
        mesh = port_mesh.in_process_mesh(("data", "model"), (1, 2), r, store)
        return tp.tp_shard_lm_params(params, cfg, mesh)

    for local in run_ranks(2, rank).values():
        for whole, shard in (
                (params["transformer"]["layers"], local["transformer"][
                    "layers"]),
                (params["depformer"]["layers"], local["depformer"][
                    "layers"])):
            for mod in ("self_attn.out_proj", "gating.linear_out"):
                a, b = mod.split(".")
                w0, w1 = whole[a][b]["weight"], shard[a][b]["weight"]
                assert w1.shape[1] * 2 == w0.shape[1]
                assert int8_dispatch(w1, 1) == int8_dispatch(w0, 1)


def test_gspmd_frame_gathers_and_matches_single_rank():
    """``shard_tree`` over (data 1, model 2) with ``lm_param_pspecs``: the
    frame gathers the cut leaves, so its tokens, transformer_out and logits
    are the single-rank frame's bit for bit, and its rings' heads are
    written back to each rank's shard."""
    _, _, single, params = tp_case(*_TP[0])
    cfg = port_lm.LMConfig(**KW)
    others = other_audio(cfg, 1)

    def rank(r, store):
        mesh = port_mesh.in_process_mesh(("data", "model"), (1, 2), r, store)
        local = sharding.shard_tree(params, sharding.lm_param_pspecs(params),
                                    mesh)
        state = port_lm.init_gen_state(cfg, 1, device="cpu")
        state = sharding.shard_tree(state, sharding.lm_state_pspecs(state),
                                    mesh)
        frames, state = run_port(cfg, local, state, others)
        return frames, state, dict(mesh.counts)

    got = run_ranks(2, rank)
    ref_state = port_lm.init_gen_state(cfg, 1, device="cpu")
    _, ref_state = run_port(cfg, params, ref_state, others)
    for r, (frames, state, counts) in got.items():
        assert isinstance(state, sharding.ShardedTree)
        for a, b in zip(frames, single):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        h = state["transformer"]["k"].shape[3]
        np.testing.assert_array_equal(
            state["transformer"]["k"].float().numpy(),
            ref_state["transformer"]["k"][:, :, :, r * h:(r + 1) * h]
            .float().numpy())
        assert counts["all_gather"] > 0
