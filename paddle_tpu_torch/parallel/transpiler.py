"""DistributeTranspiler (counterpart of ``paddle_tpu/parallel/transpiler.py``;
the reference's ``distribute_transpiler.py:139``).

The reference rewrites the trainer program into send/recv ops against
pserver programs.  Here, as in the JAX package, transpiling is a
sharding pass that gives every var a `PartitionSpec`:

- feeds: batch dim over the data axis;
- ``lookup_table(is_distributed=True)`` tables: row-sharded over the
  model axis;
- wide fc weights: column-sharded over the model axis when asked
  (``tensor_parallel_fc``);
- optimizer accumulators: sharded over the data axis with
  ``zero_stage=1`` (ZeRO-1, the pserver's remote optimizer state);
- everything else replicated.

The specs land on ``program._sharding_specs``, which `ParallelExecutor`
places the state by (`specs_rule`; ``train_loop(param_spec=
specs_rule(program))`` does the same).
The pserver role folds into the SPMD program: ``get_pserver_program``
returns the transpiled program (run it as one more rank), and async mode
(``sync_mode=False``) has no collective mapping and raises.
"""
from __future__ import annotations

from typing import Dict, Optional

from .logical_axes import PartitionSpec as P


class DistributeTranspiler:
    def __init__(self, trainer_id: int = 0, trainers: int = 1,
                 pservers: Optional[str] = None, sync_mode: bool = True):
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.sync_mode = sync_mode
        self._transpiled = None

    def transpile(self, program, mesh, data_axis: str = "dp",
                  model_axis: Optional[str] = "tp",
                  shard_embeddings: bool = True,
                  tensor_parallel_fc: bool = False,
                  zero_stage: int = 0) -> Dict[str, P]:
        specs: Dict[str, P] = {}
        block = program.global_block()
        sizes = dict(mesh.shape)
        dist_tables = set()
        for op in block.ops:
            if op.type == "lookup_table" and \
                    op.desc.attrs.get("is_distributed"):
                dist_tables.update(op.desc.inputs.get("W", []))
        tp = model_axis if model_axis in sizes else None
        tp_size = sizes.get(tp, 1)
        dp_size = sizes.get(data_axis, 1)
        for var in block.vars.values():
            name = var.name
            if var.desc.is_data:
                specs[name] = P(data_axis)
                continue
            if not var.persistable or var.shape is None:
                continue
            shape = var.shape
            if shard_embeddings and name in dist_tables and tp \
                    and len(shape) == 2 and shape[0] % tp_size == 0:
                specs[name] = P(tp, None)
            elif tensor_parallel_fc and tp and len(shape) == 2 \
                    and shape[1] % tp_size == 0 \
                    and not name.endswith(".b_0"):
                specs[name] = P(None, tp)
            elif zero_stage >= 1 and _is_accumulator(name) and shape \
                    and shape[0] % dp_size == 0:
                specs[name] = P(data_axis)
            else:
                specs[name] = P()
        program._sharding_specs = specs
        self._transpiled = program
        return specs

    def get_trainer_program(self, program=None):
        from ..core.program import default_main_program
        return program or self._transpiled or default_main_program()

    def get_pserver_program(self, endpoint, program=None):
        from ..core.program import default_main_program
        prog = program or self._transpiled or default_main_program()
        if not self.sync_mode:
            raise NotImplementedError(
                "async pserver mode (sync_mode=False) has no collective "
                "mapping; use sync mode or the ListenAndServ host service")
        return prog

    def get_startup_program(self, endpoint=None, pserver_program=None):
        from ..core.program import default_startup_program
        return default_startup_program()


_ACC_SUFFIXES = ("moment", "velocity", "_avg_squared", "mean_square",
                 "squared", "linear", "inf_norm", "beta1_pow", "beta2_pow")


def _is_accumulator(name: str) -> bool:
    low = name.lower()
    return any(s in low for s in _ACC_SUFFIXES)


def specs_rule(program):
    """``program._sharding_specs`` as a param rule (None without them)."""
    specs = getattr(program, "_sharding_specs", None)
    if not specs:
        return None

    def transpiled_specs(name, shape):
        return specs.get(name)
    return transpiled_specs
