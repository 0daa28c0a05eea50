"""Two real processes through the port's ``parallel.multihost``
(``initialize``: ``init_process_group`` with gloo over a file store in
``tmp_path``, so that parallel test workers share no port), driving the
LM frame on a mesh over both (``global_mesh``) with each process feeding
its rows (``local_batch_slice``): their tokens against the single-process
frame's, as ``tests/test_multihost.py`` holds the JAX package's.  At model
1 the processes split the sessions (data 2); at model 2 they share them
and the frame gathers the weights ``shard_tree`` cut over ``model``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from moshi_tpu_torch.models.lm import LMConfig, init_gen_state, lm_gen_step
from moshi_tpu_torch.runtime.synth import synth_lm_params

_ROOT = Path(__file__).resolve().parents[1]
_CFG = dict(dim=64, num_heads=8, num_layers=2, hidden_dim=128, context=16,
            card=32, n_q=4, dep_q=2, text_card=48, delays=(0, 0, 1, 1, 2),
            depformer_dim=32, depformer_heads=4, depformer_layers=2,
            depformer_hidden=64, depformer_low_rank=16)


def _single_process_tokens():
    cfg = LMConfig(**_CFG)
    params = synth_lm_params(cfg, None, device="cpu", seed=0)
    state = init_gen_state(cfg, 4, device="cpu")
    other = torch.zeros((4, cfg.n_q - cfg.dep_q), dtype=torch.long)
    for _ in range(3):
        out, state = lm_gen_step(cfg, params, state, other_audio=other,
                                 temp=0.0, temp_text=0.0)
    return out["sampled_text"].tolist()


@pytest.mark.parametrize("model", [1, 2])
def test_two_process_frame(tmp_path, model):
    env = dict(os.environ, PYTHONPATH=f"{_ROOT}:{os.environ.get('PYTHONPATH', '')}")
    worker = _ROOT / "tests" / "torch_multihost_worker.py"
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(store), str(i), "2", str(model),
         json.dumps(_CFG)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    parsed = {}
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        line = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST_OK")]
        assert line, out
        doc = json.loads(line[0].split(" ", 1)[1])
        parsed[doc["rank"]] = doc
    ref = _single_process_tokens()
    for rank, doc in parsed.items():
        assert doc["mesh"] == {"data": 2 // model, "model": model}
        # both processes hold the same whole batch, equal to one process's
        assert doc["full"] == ref
        lo, hi = doc["slice"]
        assert doc["local"] == ref[lo:hi]
        # the JAX package's rule: an even split over the processes
        assert doc["process_slice"] == [2 * rank, 2 * rank + 2]
        if model == 1:
            assert (lo, hi) == (2 * rank, 2 * rank + 2)
        else:
            assert (lo, hi) == (0, 4)
