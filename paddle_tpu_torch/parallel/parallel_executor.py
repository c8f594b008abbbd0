"""ParallelExecutor (counterpart of
``paddle_tpu/parallel/parallel_executor.py``; the reference's
``parallel_executor.cc:54``).

The reference replicates every op on each GPU and all-reduces each
parameter's gradient.  The port runs the program SPMD on every rank of
the world: each rank takes its slice of the feed's batch over a one-axis
mesh (``{"data": world size}``, or the ``mesh`` given), the ``backward``
rule reduces the gradients over it (averaged for a mean loss, summed
for a sum), and the update runs alike on every
rank, so parameters stay replicated (`parallel.partitioner`, fast
numerics).  A program transpiled by `DistributeTranspiler` places its
state by the transpiled specs.  ``device_count`` is the world size.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from ..core.program import Program, Variable, default_main_program
from ..core.scope import global_scope


class ParallelExecutor:
    def __init__(self, use_cuda: bool = True, loss_name: Optional[str] = None,
                 main_program: Optional[Program] = None,
                 num_threads: Optional[int] = None,
                 allow_op_delay: bool = False,
                 share_vars_from: Optional["ParallelExecutor"] = None,
                 devices: Optional[Sequence] = None, mesh=None,
                 place=None):
        import torch.distributed as dist
        from ..core.executor import Executor
        from ..core.place import CPUPlace, CUDAPlace
        from .partitioner import Partitioner, resolve_mesh
        from .transpiler import specs_rule
        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        world = dist.get_world_size() if dist.is_initialized() else 1
        if mesh is None:
            mesh = {"data": world}
        self._mesh = resolve_mesh(mesh)
        self._scope = (share_vars_from._scope if share_vars_from
                       else global_scope())
        axis = "dp" if "dp" in self._mesh.shape else self._mesh.axis_names[0]
        self._exec = Executor(place if place is not None else
                              (CUDAPlace(0) if use_cuda else CPUPlace()))
        self._exec.set_partitioner(Partitioner(
            mesh=self._mesh, data_axis=axis,
            param_spec=specs_rule(self._program)))

    @property
    def device_count(self) -> int:
        return self._mesh.size

    def run(self, fetch_list: Sequence, feed: Optional[Dict[str, Any]] = None,
            feed_dict: Optional[Dict[str, Any]] = None,
            return_numpy: bool = True):
        feed = feed if feed is not None else (feed_dict or {})
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in fetch_list]
        return self._exec.run(self._program, feed=feed,
                              fetch_list=fetch_names, scope=self._scope,
                              return_numpy=return_numpy)

    def bcast_params(self):
        """The reference's broadcast of rank 0's parameters: every rank
        starts from the same startup seed and applies the same reduced
        update, so they are equal by construction."""
        return None
