"""The parallel layer's host-side layouts against the JAX package's, bit for
bit, on the CPU: the TP layout transforms (``_interleave_perm``,
``_tp_cols`` aligned and requantized, ``_pad_gating_pair``) and the
QuantTensor slicers under them (``qt_take_rows``, ``qt_slice_cols``), the
spec trees (``tp_specs``, ``lm_param_pspecs``, ``lm_state_pspecs``,
``pp_state_pspecs`` and its refusal of the flat rings,
``tp_pp_layer_specs``), each rank's local shard of the TP, PP and TP x PP
placements against the JAX array's shard on the device at the same mesh
coordinates (``addressable_shards``), and ``serving_format``.

No frame runs here and no process group is needed: placing a tree reads
only the mesh's shape and this rank's coordinates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.lm import init_gen_state as jax_init_gen_state
from moshi_tpu.parallel import pp as jax_pp
from moshi_tpu.parallel import sharding as jax_sharding
from moshi_tpu.parallel import tp as jax_tp
from moshi_tpu.parallel import tp_pp as jax_tp_pp
from moshi_tpu.quant import formats as jax_formats
from moshi_tpu.quant import policy as jax_policy
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.parallel import pp, sharding, tp, tp_pp
from moshi_tpu_torch.parallel.mesh import Mesh
from moshi_tpu_torch.quant import formats, policy
from moshi_tpu_torch.runtime.convert import params_from_numpy
from test_torch_lm import export_numpy
from test_torch_parallel_tp import KW

_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


def bits(x) -> np.ndarray:
    """Raw bits of a tensor or a JAX / numpy array, as integers."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_qt_equal(got, ref, reshape=False):
    """Every field of the port's QuantTensor ``got`` equal to the JAX one
    ``ref`` in its bits (``reshape``: the port keeps leading axes the JAX
    package merged)."""
    assert got.fmt == ref.fmt
    for f in _FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        ga, rb = bits(a), bits(b)
        if reshape:
            ga = ga.reshape(rb.shape)
        np.testing.assert_array_equal(ga, rb, err_msg=f)


def port_qt(jqt):
    return params_from_numpy({"w": export_numpy(jqt)}, device="cpu")["w"]


def spec_tree(tree):
    """A JAX spec tree with each PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, jax_formats.QuantTensor):
        return {f: None if getattr(tree, f) is None
                else tuple(getattr(tree, f)) for f in _FIELDS}
    return tuple(tree)


def port_spec_tree(tree):
    if isinstance(tree, dict):
        return {k: port_spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, formats.QuantTensor):
        return {f: getattr(tree, f) for f in _FIELDS}
    return tuple(tree)


def test_interleave_perm():
    for rows, nsplit, s in ((12, 3, 2), (96, 3, 4), (64, 2, 2), (80, 2, 8)):
        np.testing.assert_array_equal(tp._interleave_perm(rows, nsplit, s),
                                      jax_tp._interleave_perm(rows, nsplit,
                                                              s))


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k", "q8_r"])
def test_qt_take_rows_and_slice_cols(fmt):
    """Row takes (exact), aligned column slices (exact, planar repack) and
    a misaligned one (requantized; q4_k falls back to q4_0)."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(16, 1024)) * 0.05).astype(np.float32)
    jqt = jax_formats.quantize(w, fmt)
    qt = port_qt(jqt)
    rows = np.array([3, 0, 15, 7])
    assert_qt_equal(formats.qt_take_rows(qt, rows),
                    jax_formats.qt_take_rows(jqt, rows))
    for c0, c1 in ((256, 768), (0, 512), (96, 480)):
        got = formats.qt_slice_cols(qt, c0, c1)
        assert got.shape == (16, c1 - c0)
        assert_qt_equal(got, jax_formats.qt_slice_cols(jqt, c0, c1))


@pytest.mark.parametrize("fmt,s", [("q4_k", 4), ("q4_k", 8), ("q8_0", 4),
                                   ("q4_0", 2)])
def test_tp_cols(fmt, s):
    """The column layout: per-shard planar repacks side by side where a
    shard is block-aligned (q4_k at 4 shards: 256 wide), a uniform q4_0
    requantization where not (q4_k at 8: 128 wide); stacked leaves too."""
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(2, 8, 1024)) * 0.05).astype(np.float32)
    jqts = [jax_formats.quantize(w[i], fmt) for i in range(2)]
    jqt = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jqts)
    got = tp._tp_cols(port_qt(jqt), s)
    ref = jax_tp._tp_cols(jqt, s)
    assert got.shape == tuple(ref.shape)
    assert_qt_equal(got, ref)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_pad_gating_pair(fmt):
    """A hidden width whose shards are not 32-multiples (h 192 at 4
    shards: 48) is zero-padded; the pair's arrays equal the JAX package's,
    the 2-D pair's and a stacked pair's (whose leading axes the JAX package
    merges)."""
    rng = np.random.default_rng(2)
    h, d = 192, 256
    lin_in = (rng.normal(size=(2, 2 * h, d)) * 0.05).astype(np.float32)
    lin_out = (rng.normal(size=(2, d, h)) * 0.05).astype(np.float32)
    out_fmt = "q8_0" if fmt == "q8_0" else "q4_0"

    def q(arr, f):
        qts = [jax_formats.quantize(arr[i], f) for i in range(len(arr))]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *qts)

    for stacked in (False, True):
        ji = q(lin_in, fmt) if stacked else jax_formats.quantize(lin_in[0],
                                                                 fmt)
        jo = q(lin_out, out_fmt) if stacked else jax_formats.quantize(
            lin_out[0], out_fmt)
        ri, ro = jax_tp._pad_gating_pair(ji, jo, 4)
        gi, go = tp._pad_gating_pair(port_qt(ji), port_qt(jo), 4)
        assert_qt_equal(gi, ri, reshape=stacked)
        assert_qt_equal(go, ro, reshape=stacked)


_TREES = {}


def trees():
    """(JAX config, JAX q4_k params, the port's copy), once per module."""
    if not _TREES:
        jcfg = JaxLMConfig(**KW)
        jparams = jax_synth_lm_params(jax.random.PRNGKey(0), jcfg,
                                      fmt="q4_k")
        _TREES.update(cfg=jcfg, jax=jparams, port=params_from_numpy(
            export_numpy(jparams), device="cpu"))
    return _TREES["cfg"], _TREES["jax"], _TREES["port"]


def test_spec_trees_match_jax():
    jcfg, jparams, params = trees()
    assert port_spec_tree(sharding.lm_param_pspecs(params)) == spec_tree(
        jax_sharding.lm_param_pspecs(jparams))
    assert port_spec_tree(tp.tp_specs(params)) == spec_tree(
        jax_tp.tp_specs(jparams))
    lay, jlay = (params["transformer"]["layers"],
                 jparams["transformer"]["layers"])
    assert port_spec_tree(tp_pp.tp_pp_layer_specs(lay)) == spec_tree(
        jax_tp_pp.tp_pp_layer_specs(jlay))
    assert port_spec_tree(pp.pp_layer_specs(lay)) == spec_tree(
        jax_pp.pp_layer_specs(jlay))
    jstate = jax_init_gen_state(jcfg, 2, jax.random.PRNGKey(0))
    state = port_lm.init_gen_state(port_lm.LMConfig(**KW), 2, device="cpu")
    jstate = {k: v for k, v in jstate.items() if k != "rng"}
    for ours, theirs in (
            (sharding.lm_state_pspecs, jax_sharding.lm_state_pspecs),
            (pp.pp_state_pspecs, jax_pp.pp_state_pspecs),
            (tp_pp.tp_pp_state_pspecs, jax_tp_pp.tp_pp_state_pspecs)):
        assert port_spec_tree(ours(state)) == spec_tree(theirs(jstate))


def test_pp_state_pspecs_refuses_the_flat_rings():
    flat = {"k": torch.zeros((4, 8, 16)), "v": torch.zeros((4, 8, 16))}
    with pytest.raises(ValueError, match="stacked KV layout"):
        pp.pp_state_pspecs(flat)
    with pytest.raises(ValueError, match="stacked layout"):
        tp_pp.tp_pp_state_pspecs(flat)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (formats.QuantTensor, jax_formats.QuantTensor)):
        for f in _FIELDS:
            if getattr(tree, f) is not None:
                yield f"{path}.{f}", getattr(tree, f)
    else:
        yield path, tree


_PLACEMENTS = {
    "tp": (("data", "model"), (2, 2)),
    "pp": (("data", "pp"), (2, 2)),
    "tp_pp": (("data", "model", "pp"), (1, 2, 2)),
}


@pytest.mark.parametrize("kind", sorted(_PLACEMENTS))
def test_local_shards_are_the_jax_arrays_shards(kind):
    """Each rank's leaves (every QuantTensor field) equal the JAX package's
    placed array's shard on the device at the rank's mesh coordinates."""
    jcfg, jparams, params = trees()
    cfg = port_lm.LMConfig(**KW)
    names, sizes = _PLACEMENTS[kind]
    devices = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    jmesh = jax.sharding.Mesh(devices, names)
    placed = {"tp": lambda: jax_tp.tp_shard_lm_params(jparams, jcfg, jmesh),
              "pp": lambda: jax_pp.pp_shard_lm_params(jparams, jcfg, jmesh),
              "tp_pp": lambda: jax_tp_pp.tp_pp_shard_lm_params(
                  jparams, jcfg, jmesh)}[kind]()
    ref = dict(_leaves(placed))
    for rank in range(devices.size):
        mesh = Mesh(names, np.arange(devices.size).reshape(sizes), rank, {})
        local = {"tp": tp.tp_shard_lm_params, "pp": pp.pp_shard_lm_params,
                 "tp_pp": tp_pp.tp_pp_shard_lm_params}[kind](params, cfg,
                                                             mesh)
        device = devices.flat[rank]
        got = dict(_leaves(local))
        assert got.keys() == ref.keys()
        for path, arr in ref.items():
            shard = [s for s in arr.addressable_shards
                     if s.device == device][0]
            np.testing.assert_array_equal(bits(got[path]), bits(shard.data),
                                          err_msg=f"{kind} rank {rank} "
                                                  f"{path}")


def test_serving_format_matches_jax():
    for fmt in ("q4_k", "q4_0", "q8_0", "q8_r", "bf16", None):
        for sharded in (False, True):
            for batch in (1, 4):
                assert policy.serving_format(fmt, batch, sharded) == \
                    jax_policy.serving_format(fmt, batch, sharded)
