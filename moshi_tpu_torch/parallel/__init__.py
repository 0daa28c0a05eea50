"""The parallel layer on ``torch.distributed``: the mesh and its
collectives (``mesh``), GSPMD-style shardings (``sharding``), tensor
(``tp``), pipeline (``pp``), both (``tp_pp``) and expert (``ep``)
parallelism, and several processes (``multihost``)."""

from moshi_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, lm_param_pspecs, lm_state_pspecs, shard_tree, replicate_tree,
)
from moshi_tpu_torch.parallel.tp import (  # noqa: F401
    current_tp, tp_scope, tp_shard_lm_params, tp_specs,
)
from moshi_tpu_torch.parallel.pp import (  # noqa: F401
    current_pp, make_pp_mesh, pp_scope, pp_shard_lm_params,
    pp_shard_lm_state,
)
from moshi_tpu_torch.parallel.tp_pp import (  # noqa: F401
    make_tp_pp_mesh, tp_pp_shard_lm_params, tp_pp_shard_lm_state,
)
