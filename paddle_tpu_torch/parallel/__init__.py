"""Data, tensor, sequence and pipeline parallelism and row-sharded
embedding tables over ``torch.distributed`` (counterpart of
``paddle_tpu/parallel``): every rank runs the same program (SPMD) on a
`Mesh` of named axes, a `Partitioner` places state and feeds by rule,
`collectives` carries the exchanges, `embedding` row-shards lookup
tables over an ``"ep"`` axis, `tiered` trains a table out of host RAM,
`ring_attention` shards attention over the sequence (ring and Ulysses)
and `pipeline` runs GPipe stages over a ``"pp"`` axis."""
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
from .ring_attention import (ring_attention_local,  # noqa: F401
                             ulysses_attention_local,
                             sequence_parallel_attention,
                             reference_attention)
from .embedding import (sharded_embedding_lookup,  # noqa: F401
                        shard_table)
from .pipeline import (pipeline_apply, pipeline_local,  # noqa: F401
                       pipeline_reference, pipeline_window,
                       bubble_fraction)
