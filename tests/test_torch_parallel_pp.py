"""The port's pipeline-parallel and TP x PP frames (``moshi_tpu_torch/
parallel/pp.py``, ``tp_pp.py``) against the JAX package's scoped frames on
the same q4_k weights, its expert-parallel depformer (``parallel/ep.py``)
against the unsharded frame, bit for bit, and the scopes' dispatch rules,
on the CPU.

Ranks are threads with gloo groups of their own, as in
``test_torch_parallel_tp.py`` (whose helpers and tiny configuration these
tests share); JAX's frames run with Pallas in interpret mode on the
conftest's 8 CPU devices.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.lm import init_gen_state as jax_init_gen_state
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn.transformer import (init_transformer_state,
                                            transformer_forward)
from moshi_tpu_torch.parallel import ep, pp, tp, tp_pp
from moshi_tpu_torch.parallel import mesh as port_mesh
from moshi_tpu_torch.runtime.convert import params_from_numpy
from moshi_tpu_torch.runtime.synth import synth_lm_params
from test_torch_lm import export_numpy
from test_torch_parallel_tp import (FRAMES, KW, _one_thread,  # noqa: F401
                                    _recorded_logits, assert_frames_match,
                                    joined, other_audio, run_jax, run_port,
                                    run_ranks)

_PARAMS = {}


def params():
    """(JAX q4_k params, the port's copy), once per module."""
    if not _PARAMS:
        jparams = jax_synth_lm_params(jax.random.PRNGKey(0),
                                      JaxLMConfig(**KW), fmt="q4_k")
        _PARAMS["jax"] = jparams
        _PARAMS["port"] = params_from_numpy(export_numpy(jparams),
                                            device="cpu")
    return _PARAMS["jax"], _PARAMS["port"]


def _pp_rank(cfg, whole, others, data, stages, batch, model=1):
    """The per-rank function of a (data, pp) or (data, model, pp) run:
    (frames of this rank's rows, collective counts)."""
    def rank(r, store):
        if model == 1:
            mesh = port_mesh.in_process_mesh(("data", "pp"), (data, stages),
                                             r, store)
            local = pp.pp_shard_lm_params(whole, cfg, mesh)
            state = pp.pp_shard_lm_state(
                port_lm.init_gen_state(cfg, batch, device="cpu"), mesh)
            scopes = [pp.pp_scope(mesh, cfg.transformer)]
        else:
            mesh = port_mesh.in_process_mesh(("data", "model", "pp"),
                                             (data, model, stages), r, store)
            local = tp_pp.tp_pp_shard_lm_params(whole, cfg, mesh)
            state = tp_pp.tp_pp_shard_lm_state(
                port_lm.init_gen_state(cfg, batch, device="cpu"), mesh)
            scopes = [tp.tp_scope(mesh), pp.pp_scope(mesh, cfg.transformer)]
        per = batch // data
        i = mesh.index("data")
        with contextlib.ExitStack() as stack:
            for scope in scopes:
                stack.enter_context(scope)
            frames, _ = run_port(cfg, local, state, others,
                                 slice(i * per, (i + 1) * per))
        return frames, dict(mesh.counts)
    return rank


def _jax_ref(jcfg, jparams, batch, mesh_kind, data, stages, model=1):
    from moshi_tpu.parallel import (make_pp_mesh, make_tp_pp_mesh, pp_scope,
                                    pp_shard_lm_params, pp_shard_lm_state,
                                    tp_pp_shard_lm_params,
                                    tp_pp_shard_lm_state, tp_scope)
    others = other_audio(jcfg, batch)
    state = jax_init_gen_state(jcfg, batch, jax.random.PRNGKey(5))
    if mesh_kind == "pp":
        mesh = make_pp_mesh(pp=stages, data=data)
        with pp_scope(mesh, jcfg.transformer):
            return run_jax(jcfg, pp_shard_lm_params(jparams, jcfg, mesh),
                           pp_shard_lm_state(state, mesh), others)
    mesh = make_tp_pp_mesh(data=data, model=model, pp=stages)
    with tp_scope(mesh), pp_scope(mesh, jcfg.transformer):
        return run_jax(jcfg, tp_pp_shard_lm_params(jparams, jcfg, mesh),
                       tp_pp_shard_lm_state(state, mesh), others)


_PP = [(1, 2, 2), (2, 2, 4)]


@pytest.mark.parametrize("data,stages,batch", _PP,
                         ids=[f"d{c[0]}pp{c[1]}b{c[2]}" for c in _PP])
def test_pp_frame_matches_jax(data, stages, batch):
    jparams, whole = params()
    jcfg = JaxLMConfig(**KW)
    cfg = port_lm.LMConfig(**KW)
    ref = _jax_ref(jcfg, jparams, batch, "pp", data, stages)
    others = other_audio(cfg, batch)
    got = run_ranks(data * stages,
                    _pp_rank(cfg, whole, others, data, stages, batch))
    # every stage of a data shard holds the same rows, bit for bit
    for d in range(data):
        for s in range(1, stages):
            for a, b in zip(got[d * stages + s][0], got[d * stages][0]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    firsts = [d * stages for d in range(data)]
    assert_frames_match(joined({r: got[r][0] for r in firsts}, firsts), ref)
    # per frame: 2(S-1) ppermutes and one psum over pp
    for r, (_, counts) in got.items():
        assert counts == {"ppermute": 2 * (stages - 1) * FRAMES,
                          "psum": FRAMES}, r


def test_tp_pp_frame_matches_jax():
    """(data 1, model 2, pp 2): four ranks, TP within each stage."""
    jparams, whole = params()
    jcfg = JaxLMConfig(**KW)
    cfg = port_lm.LMConfig(**KW)
    batch = 2
    ref = _jax_ref(jcfg, jparams, batch, "tp_pp", 1, 2, model=2)
    got = run_ranks(4, _pp_rank(cfg, whole, other_audio(cfg, batch), 1, 2,
                                batch, model=2))
    for r in range(1, 4):
        for a, b in zip(got[r][0], got[0][0]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert_frames_match(got[0][0], ref)
    # per rank and frame: 2 psums a temporal layer of the stage for each
    # microbatch, the depformer's 2 a layer and step, the pp psum; the
    # ppermutes; the text and step logits gathered
    stage_layers = cfg.num_layers // 2
    psums = (2 * stage_layers * 2 + 2 * cfg.depformer_layers * cfg.dep_q
             + 1)
    for r, (_, counts) in got.items():
        assert counts == {"psum": psums * FRAMES, "ppermute": 2 * FRAMES,
                          "all_gather": (1 + cfg.dep_q) * FRAMES}, r


def test_pp_microbatch_is_the_b1_frame():
    """A microbatch of one session runs the B = 1 frame's kernels over the
    same layers in the same order: each session's transformer_out under PP
    (B = 2, two stages) equals its own B = 1 frame's, bit for bit."""
    _, whole = params()
    cfg = port_lm.LMConfig(**KW)
    others = other_audio(cfg, 2)
    got = run_ranks(2, _pp_rank(cfg, whole, others, 1, 2, 2))
    for b in range(2):
        single, _ = run_port(cfg, whole,
                             port_lm.init_gen_state(cfg, 1, device="cpu"),
                             others[:, b:b + 1])
        for f in range(FRAMES):
            np.testing.assert_array_equal(got[0][0][f]["h"][b],
                                          single[f]["h"][0])


_EP = dict(dim=128, num_heads=4, num_layers=2, hidden_dim=256, context=32,
           card=128, n_q=6, dep_q=4, text_card=256,
           delays=(0, 0, 1, 1, 1, 1, 2), depformer_dim=128,
           depformer_heads=4, depformer_layers=2, depformer_hidden=256,
           depformer_low_rank=16)


def test_ep_depformer_matches_unsharded():
    """bf16 at model 4, on the JAX package's weights: each rank holds one
    of the 4 per-step weight sets, the frames equal the port's unsharded
    frames bit for bit, they match JAX's expert-parallel frame (its
    ``ep_shard_depformer`` on 4 devices) as the TP frames match JAX's, and
    each step broadcasts its cut leaves from their owner."""
    from moshi_tpu.parallel import make_mesh as jax_make_mesh
    from moshi_tpu.parallel.ep import ep_shard_depformer as jax_ep_shard
    jcfg = JaxLMConfig(**_EP)
    jparams = jax_synth_lm_params(jax.random.PRNGKey(0), jcfg, fmt=None)
    cfg = port_lm.LMConfig(**_EP)
    whole = params_from_numpy(export_numpy(jparams), device="cpu")
    others = other_audio(cfg, 1)
    jmesh = jax_make_mesh(data=1, model=4, devices=jax.devices()[:4])
    with jmesh:
        jax_ref = run_jax(jcfg, jax_ep_shard(jparams, jcfg, jmesh),
                          jax_init_gen_state(jcfg, 1, jax.random.PRNGKey(5)),
                          others)
    ref, _ = run_port(cfg, whole,
                      port_lm.init_gen_state(cfg, 1, device="cpu"), others)

    def rank(r, store):
        mesh = port_mesh.in_process_mesh(("data", "model"), (1, 4), r, store)
        local = ep.ep_shard_depformer(whole, cfg, mesh)
        dep = local["depformer"]
        assert isinstance(dep["in"]["weight"], ep.StepShards)
        assert dep["in"]["weight"].local.shape[0] == 1
        assert isinstance(dep["linears"]["weight"], ep.StepShards)
        # the [dep_q - 1] embeddings and the [L] norm stacks stay whole
        assert torch.is_tensor(dep["emb"]["weight"])
        assert torch.is_tensor(dep["layers"]["norm1"]["alpha"])
        frames, _ = run_port(cfg, local,
                             port_lm.init_gen_state(cfg, 1, device="cpu"),
                             others)
        return frames, dict(mesh.counts)

    got = run_ranks(4, rank)
    cut = 6          # in, in_proj, out_proj, linear_in, linear_out, linears
    for r, (frames, counts) in got.items():
        for a, b in zip(frames, ref):
            for k in ("text", "audio", "h", "logits"):
                np.testing.assert_array_equal(a[k], b[k])
        assert_frames_match(frames, jax_ref)
        assert counts == {"broadcast": cut * cfg.dep_q * FRAMES}, r


def test_ep_keeps_a_leaf_whose_leading_axis_merely_divides():
    """A [L] norm stack with L == 2 on a 2-way axis is not a step axis."""
    cfg = port_lm.LMConfig(**_EP)
    whole = synth_lm_params(cfg, None, device="cpu", seed=0)

    def rank(r, store):
        mesh = port_mesh.in_process_mesh(("data", "model"), (1, 2), r, store)
        return ep.ep_shard_depformer(whole, cfg, mesh)

    for local in run_ranks(2, rank).values():
        n1 = local["depformer"]["layers"]["norm1"]["alpha"]
        assert torch.is_tensor(n1) and n1.shape[0] == cfg.depformer_layers


def test_pp_matches_refuses_another_stack_of_the_same_depth():
    cfg = port_lm.LMConfig(**KW)
    mesh = port_mesh.build_mesh(("data", "pp"), (1, 1))
    with pp.pp_scope(mesh, cfg.transformer):
        ctx = pp.current_pp()
        assert ctx.matches(cfg.transformer)
        other = dataclasses.replace(cfg.transformer, dim=128)
        assert other.num_layers == cfg.transformer.num_layers
        assert not ctx.matches(other)
    with pp.pp_scope(mesh, cfg.transformer.num_layers):
        assert pp.current_pp().matches(cfg.transformer)
    assert pp.current_pp() is None


def test_scopes_refuse_what_they_cannot_shard():
    """Under a scope a quantized stack that misses the stacked decode's
    preconditions (a T = 3 prefill) raises, and so does a depformer that
    misses the stacked form's (dense weights), as in the JAX package."""
    _, whole = params()
    cfg = port_lm.LMConfig(**KW)
    tcfg = cfg.transformer
    mesh = port_mesh.build_mesh(("data", "pp"), (1, 1))
    x = torch.zeros((2, 3, tcfg.dim), dtype=torch.bfloat16)
    with pp.pp_scope(mesh, tcfg):
        with pytest.raises(ValueError, match="stacked-decode"):
            transformer_forward(tcfg, whole["transformer"],
                                init_transformer_state(tcfg, 2, "cpu"), x,
                                torch.zeros((2,), dtype=torch.int32))
    dense = synth_lm_params(cfg, None, device="cpu", seed=0)
    tmesh = port_mesh.build_mesh(("data", "model"), (1, 1))
    with tp.tp_scope(tmesh):
        with pytest.raises(ValueError, match="stacked-kernel"):
            port_lm.depformer_generate(
                cfg, dense, torch.zeros((1, cfg.dim), dtype=torch.bfloat16),
                torch.zeros((1,), dtype=torch.long), 0.0, 1)
