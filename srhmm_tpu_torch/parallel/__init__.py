"""Multi-device training with torch.distributed (counterpart of
``srhmm_tpu/parallel``): one process per rank, explicit collectives.

  distributed.py  process-group bootstrap, the backend rule, the
                  collectives, spawning a group of ranks on one host
  mesh.py         (data, model) meshes, batch and mixture sharding,
                  em_step_sharded
  sequence.py     time-sharded lattices and E-step
  dryrun.py       dryrun_multichip: every sharded path on n ranks
"""

from . import distributed
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    em_step_sharded,
    gather_model,
    make_mesh,
    replicate,
    shard_batch,
    shard_model,
)
from .sequence import (
    TIME_AXIS,
    e_step_time_sharded,
    log_backward_time_sharded,
    log_forward_time_sharded,
    make_time_mesh,
    pad_time,
)

__all__ = [
    "distributed",
    "DATA_AXIS",
    "MODEL_AXIS",
    "TIME_AXIS",
    "Mesh",
    "e_step_time_sharded",
    "em_step_sharded",
    "gather_model",
    "log_backward_time_sharded",
    "log_forward_time_sharded",
    "make_mesh",
    "make_time_mesh",
    "pad_time",
    "replicate",
    "shard_batch",
    "shard_model",
]
