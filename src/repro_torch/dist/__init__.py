"""repro_torch.dist — sharded execution: expert parallelism, sharding
rules as DTensor placements, tensor parallelism on the model axis
(``tensor_parallel``), params gathered per layer (``layer_gather``), the
sharded train step, and elastic /
fault-tolerant training (a copy of the reference's framework-free
``dist/elastic.py``)."""
from repro_torch.dist.elastic import (StepWatchdog, UpdateInterrupted,
                                      elastic_mesh, run_with_restarts)
from repro_torch.dist.ep_moe import ep_moe_ffn
from repro_torch.dist.sharding import (PartitionSpec, batch_pspec,
                                       cache_pspecs, mesh_axes, opt_pspecs,
                                       param_pspecs, placements_from_pspecs)

__all__ = [
    "StepWatchdog", "UpdateInterrupted", "elastic_mesh", "run_with_restarts",
    "ep_moe_ffn", "PartitionSpec", "batch_pspec", "cache_pspecs",
    "mesh_axes", "opt_pspecs", "param_pspecs", "placements_from_pspecs",
]
