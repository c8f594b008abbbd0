"""Program IR: Program ⊃ Block ⊃ {Operator, Variable} (counterpart of
``paddle_tpu/core/program.py``).

The Program is build-time metadata: the front end appends ops to it, and
the Executor interprets the global block op by op with torch functions
(`core.lowering`).  Serialization is the JAX package's JSON, field for
field, so a program built by either package parses in the other.

Ported as far as the training and serving programs need: sub-blocks (a
DynamicRNN's step block, ``create_block``/``rollback``),
``clone(for_test=True)`` and ``prune(targets)`` (what
``io.save_inference_model`` exports) and `Variable`'s operator sugar.
Like the JAX package's, the ``amp`` flag (default ``FLAGS.amp``), the
``exact_lowering`` flag and the loss scaler's ``_loss_scaling`` marker
are not part of the JSON, and an attribute's tuples come back from it as
lists.

``exact_lowering`` (default False; kept by ``clone`` and ``prune``) is
the decode engine's ``numerics="exact"``.  The JAX package fences XLA's
fusion with it; here it selects the kernels whose row results do not
depend on the batch: ``mul`` runs the row-stable product kernel in f32
and ``fused_attention`` the flash forward in f32.  `Block.prepend_op` puts
an op first (the LR schedules' step counter).
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import types as core_types
from .. import unique_name
from ..flags import FLAGS


class VarDesc:
    """A variable's description (framework.proto VarDesc)."""

    __slots__ = ("name", "shape", "dtype", "type", "persistable",
                 "stop_gradient", "lod_level", "is_data", "initializer",
                 "trainable", "regularizer", "optimize_attr", "error_clip",
                 "gradient_clip_attr", "do_model_average")

    def __init__(self, name, shape=None, dtype="float32",
                 type=core_types.VarType.LOD_TENSOR, persistable=False,
                 stop_gradient=False, lod_level=0, is_data=False):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = (core_types.convert_dtype(dtype) if dtype is not None
                      else None)
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_data = is_data
        # parameter-only attributes
        self.initializer = None
        self.trainable = True
        self.regularizer = None
        self.optimize_attr = {"learning_rate": 1.0}
        self.error_clip = None
        self.gradient_clip_attr = None
        self.do_model_average = False

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": self.type.value,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "is_data": self.is_data,
            "trainable": self.trainable,
        }

    @staticmethod
    def from_dict(d):
        v = VarDesc(d["name"], d["shape"], d["dtype"],
                    core_types.VarType(d["type"]), d["persistable"],
                    d["stop_gradient"], d["lod_level"], d["is_data"])
        v.trainable = d.get("trainable", True)
        return v


class OpDesc:
    """An op's description: type, named input/output variable lists and
    attributes (framework.proto OpDesc)."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type: str,
                 inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def to_dict(self):
        def _clean(a):
            if isinstance(a, np.ndarray):
                return {"__ndarray__": a.tolist(), "dtype": str(a.dtype)}
            return a
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": {k: _clean(v) for k, v in self.attrs.items()
                          if not k.startswith("_py_")}}

    @staticmethod
    def from_dict(d):
        def _restore(a):
            if isinstance(a, dict) and "__ndarray__" in a:
                return np.asarray(a["__ndarray__"], dtype=a["dtype"])
            return a
        return OpDesc(d["type"], d["inputs"], d["outputs"],
                      {k: _restore(v) for k, v in d["attrs"].items()})

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"


class Variable:
    """Handle to a VarDesc inside a Block."""

    def __init__(self, block: "Block", desc: VarDesc):
        self.block = block
        self.desc = desc

    @property
    def name(self):
        return self.desc.name

    @property
    def shape(self):
        return self.desc.shape

    @property
    def dtype(self):
        return self.desc.dtype

    @property
    def persistable(self):
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v):
        self.desc.persistable = v

    @property
    def stop_gradient(self):
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v):
        self.desc.stop_gradient = v

    @property
    def lod_level(self):
        return self.desc.lod_level

    @property
    def type(self):
        return self.desc.type

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype})")

    # -- operator sugar: each operator appends the JAX package's ops ----------
    def _binary(self, other, op_type, reverse=False):
        from .. import layers
        if not isinstance(other, Variable):
            other = layers.fill_constant(shape=[1], dtype=self.dtype,
                                         value=float(other))
        x, y = (other, self) if reverse else (self, other)
        return layers.elementwise_op(op_type, x, y)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __matmul__(self, o):
        from .. import layers
        return layers.matmul(self, o)

    def _cmp(self, other, op_type):
        from .. import layers
        return layers.compare_op(op_type, self, other)

    def __lt__(self, o):
        return self._cmp(o, "less_than")

    def __le__(self, o):
        return self._cmp(o, "less_equal")

    def __gt__(self, o):
        return self._cmp(o, "greater_than")

    def __ge__(self, o):
        return self._cmp(o, "greater_equal")

    def astype(self, dtype):
        from .. import layers
        return layers.cast(self, dtype)


class Parameter(Variable):
    """Persistable, trainable Variable."""

    @property
    def trainable(self):
        return self.desc.trainable

    @trainable.setter
    def trainable(self, v):
        self.desc.trainable = v

    @property
    def regularizer(self):
        return self.desc.regularizer

    @property
    def optimize_attr(self):
        return self.desc.optimize_attr


class Operator:
    """Handle to an OpDesc."""

    def __init__(self, block: "Block", desc: OpDesc):
        self.block = block
        self.desc = desc

    @property
    def type(self):
        return self.desc.type

    def __repr__(self):
        return repr(self.desc)


class Block:
    """An ordered op list over named variables."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name=None, shape=None, dtype="float32",
                   type=core_types.VarType.LOD_TENSOR, persistable=False,
                   stop_gradient=False, lod_level=0,
                   is_data=False) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        desc = VarDesc(name, shape, dtype, type, persistable,
                       stop_gradient, lod_level, is_data)
        var = Variable(self, desc)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype, initializer=None,
                         trainable=True, regularizer=None,
                         gradient_clip_attr=None, do_model_average=False,
                         learning_rate=1.0) -> Parameter:
        desc = VarDesc(name, shape, dtype, persistable=True)
        desc.initializer = initializer
        desc.trainable = trainable
        desc.regularizer = regularizer
        desc.gradient_clip_attr = gradient_clip_attr
        desc.do_model_average = do_model_average
        desc.optimize_attr = {"learning_rate": learning_rate}
        p = Parameter(self, desc)
        self.vars[name] = p
        return p

    @property
    def parent_block(self) -> Optional["Block"]:
        return (self.program.blocks[self.parent_idx]
                if self.parent_idx >= 0 else None)

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"Variable '{name}' not found in block {self.idx}")
        return v

    def has_var(self, name) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        block = self
        while block is not None:
            if name in block.vars:
                return block.vars[name]
            block = (block.program.blocks[block.parent_idx]
                     if block.parent_idx >= 0 else None)
        return None

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        def _names(d):
            out = {}
            for k, v in (d or {}).items():
                if v is None:
                    out[k] = []
                elif isinstance(v, (list, tuple)):
                    out[k] = [x.name if isinstance(x, Variable) else x
                              for x in v]
                else:
                    out[k] = [v.name if isinstance(v, Variable) else v]
            return out

        desc = OpDesc(type, _names(inputs), _names(outputs), attrs)
        # every op records whether it belongs to the forward, the backward
        # or the optimize pass
        desc.attrs.setdefault("op_role", self.program._op_role)
        op = Operator(self, desc)
        self.ops.append(op)
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        """`append_op`, then move the op to the front of the block (the
        LR schedules' step counter runs first in every step)."""
        op = self.append_op(type, inputs, outputs, attrs)
        self.ops.insert(0, self.ops.pop())
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.desc.to_dict() for v in self.vars.values()],
            "ops": [op.desc.to_dict() for op in self.ops],
        }


class Program:
    """Blocks of ops; block 0 is the global block."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._seed = None            # program-level RNG seed
        self._op_role = "forward"    # forward | backward | optimize
        self._amp = FLAGS.amp        # bf16 compute on conv/matmul ops
        #: row-stable kernels for every product and attention (module
        #: docstring)
        self.exact_lowering = False
        #: the loss scaler's var names (`optimizer.MixedPrecision`), read
        #: by the executor's non-finite check; None without a scaler
        self._loss_scaling = None
        #: the reader-op pipeline `layers.read_file` bound; the executor
        #: pulls from it when a step has no feed
        self._bound_reader = None

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        """A new sub-block (a DynamicRNN's step block) under the current
        block, or under ``parent_idx``; it becomes the current block."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = self.current_block().parent_idx

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, s):
        self._seed = s

    @property
    def amp(self):
        """Mixed precision: conv and matmul operands are cast to bf16 and
        their f32-declared outputs stay bf16; parameters, optimizer state
        and statistics stay f32 (master weights).  Off by default."""
        return self._amp

    @amp.setter
    def amp(self, on: bool):
        self._amp = bool(on)

    def list_vars(self):
        for block in self.blocks:
            yield from block.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    # -- whole-program transforms -------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """A deep copy; ``for_test=True`` keeps only the forward ops and
        sets ``is_test`` on the ops that behave differently in inference
        (dropout scales instead of masking, BatchNorm reads its running
        statistics)."""
        p = copy.deepcopy(self)
        if for_test:
            for block in p.blocks:
                block.ops = [op for op in block.ops
                             if op.desc.attrs.get("op_role", "forward")
                             == "forward"]
                for op in block.ops:
                    if "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                        op.desc.attrs["is_test"] = True
            p._op_role = "forward"
        p._drop_stale_loss_scaling()
        return p

    def _drop_stale_loss_scaling(self):
        """A copy without the ``check_finite_and_unscale`` op (the only
        writer of the scaler's found_inf) drops the ``_loss_scaling``
        marker too, or the executor would fetch a var no op writes."""
        if self._loss_scaling and not any(
                op.type == "check_finite_and_unscale"
                for op in self.global_block().ops):
            self._loss_scaling = None

    def prune(self, targets: Sequence) -> "Program":
        """A copy whose global block keeps only the ops that ``targets``
        need (a backward slice of the op list), and only the variables
        those ops and their sub-blocks use."""
        target_names = {t.name if isinstance(t, Variable) else t
                        for t in targets}
        p = self.clone()
        block = p.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(block.ops):
            if set(op.desc.output_names()) & needed or op.type == "feed":
                kept.append(op)
                needed |= set(op.desc.input_names())
        block.ops = list(reversed(kept))
        used = set()
        for op in block.ops:
            used |= set(op.desc.input_names()) | set(op.desc.output_names())
        # a kept sub-block (a DynamicRNN's step block) reads its
        # parameters from block 0
        for bi in {op.desc.attrs["sub_block"] for op in block.ops
                   if "sub_block" in op.desc.attrs}:
            for op in p.blocks[bi].ops:
                used |= (set(op.desc.input_names())
                         | set(op.desc.output_names()))
        block.vars = {k: v for k, v in block.vars.items()
                      if k in used or k in target_names}
        p._drop_stale_loss_scaling()
        return p

    # -- serialization -------------------------------------------------------
    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks], "version": 1}

    def serialize_to_string(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def parse_from_string(s: str) -> "Program":
        d = json.loads(s)
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                desc = VarDesc.from_dict(vd)
                # the JAX package's rule: a persistable, trainable,
                # shaped non-data var parses as a Parameter
                cls = Parameter if (desc.persistable and desc.trainable
                                    and not desc.is_data and desc.shape
                                    and vd.get("trainable") is not None
                                    ) else Variable
                b.vars[desc.name] = cls(b, desc)
            for od in bd["ops"]:
                b.ops.append(Operator(b, OpDesc.from_dict(od)))
            p.blocks.append(b)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        return p


#: ops whose behaviour differs between training and inference
_TEST_MODE_OPS = {"dropout": ("is_test",), "batch_norm": ("is_test",),
                  "layer_norm": ()}


# ---------------------------------------------------------------------------
# default programs and guards
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


class program_guard:
    """Context manager swapping the default programs."""

    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        global _main_program, _startup_program
        self._old = (_main_program, _startup_program)
        _main_program = self.main
        if self.startup is not None:
            _startup_program = self.startup
        return self

    def __exit__(self, *exc):
        global _main_program, _startup_program
        _main_program, _startup_program = self._old
        return False


def reset_default_programs():
    """Fresh default programs and names (test isolation)."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    unique_name.generator = unique_name.UniqueNameGenerator()
