"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``paddle_tpu/parallel``, the mesh, partitioner and transpiler of ROADMAP
queue A item 4a): every rank runs the same program (SPMD) on a `Mesh`
of named axes, a `Partitioner` places state and feeds by rule, and
`collectives` carries the exchanges.  Ring and Ulysses attention,
sharded embeddings and pipelines come with items 4b and 4c."""
from .parallel_executor import ParallelExecutor  # noqa: F401
from .mesh import (create_mesh, create_hybrid_mesh,  # noqa: F401
                   create_training_mesh, get_mesh, set_mesh, Mesh,
                   NamedSharding, replicated, shard_batch,
                   init_distributed, cpu_multiprocess_collectives_supported)
from .partitioner import (Partitioner, ParamSpecRule,  # noqa: F401
                          parse_mesh_axes, resolve_mesh, spec_fits)
from .logical_axes import (LogicalAxisRules, PartitionSpec,  # noqa: F401
                           transformer_tp_rules)
from .transpiler import DistributeTranspiler  # noqa: F401
