"""Worker process of ``tests/test_torch_parallel_multihost.py``: one rank
of a two-process run of the port's LM frame through
``parallel.multihost`` (``initialize`` over a file store with gloo,
``global_mesh``, ``local_batch_slice``), on the CPU.

    python tests/torch_multihost_worker.py STORE RANK WORLD MODEL

Prints ``MULTIHOST_OK`` and a JSON object: this rank's text tokens, the
whole batch's (gathered over ``data``) and its batch slice.
"""

import json
import sys


def main():
    store, rank, world, model = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), int(sys.argv[4]))
    import torch
    torch.set_num_threads(1)
    from moshi_tpu_torch.models.lm import (LMConfig, init_gen_state,
                                           lm_gen_step)
    from moshi_tpu_torch.parallel import (lm_param_pspecs, lm_state_pspecs,
                                          multihost, shard_tree)
    from moshi_tpu_torch.parallel.mesh import all_gather
    from moshi_tpu_torch.runtime.synth import synth_lm_params

    multihost.initialize(f"file://{store}", num_processes=world,
                         process_id=rank, backend="gloo")
    import torch.distributed as dist
    assert dist.get_world_size() == world and dist.get_rank() == rank
    mesh = multihost.global_mesh(model=model)
    cfg = LMConfig(**json.loads(sys.argv[5]))
    batch = 4
    params = synth_lm_params(cfg, None, device="cpu", seed=0)
    params = shard_tree(params, lm_param_pspecs(params), mesh)
    state = init_gen_state(cfg, batch, device="cpu")
    state = shard_tree(state, lm_state_pspecs(state), mesh)
    rows = multihost.local_batch_slice(batch, mesh)
    other = torch.zeros((batch, cfg.n_q - cfg.dep_q), dtype=torch.long)
    for _ in range(3):
        out, state = lm_gen_step(cfg, params, state, other_audio=other[rows],
                                 temp=0.0, temp_text=0.0)
    local = out["sampled_text"]
    full = all_gather(mesh, "data", local, dim=0)
    print("MULTIHOST_OK", json.dumps({
        "rank": rank, "local": local.tolist(), "full": full.tolist(),
        "slice": [rows.start, rows.stop],
        "process_slice": [multihost.local_batch_slice(batch).start,
                          multihost.local_batch_slice(batch).stop],
        "mesh": mesh.shape}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
