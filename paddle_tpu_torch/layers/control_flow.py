"""Control-flow layers (counterpart of ``paddle_tpu/layers/control_flow.py``,
whole): DynamicRNN, StaticRNN, While, IfElse, ConditionalBlock, Switch,
ParallelDo, the tensor arrays, the LoD rank-table helpers, increment and
Print.

DynamicRNN/StaticRNN build a step sub-block and one ``dynamic_rnn`` op,
which ``ops/rnn_ops.py`` runs over time; the other constructs build
sub-blocks that ``ops/control_ops.py`` runs, with the JAX package's
attributes (``sub_block``, ``carry_vars``, ``max_trip_count``...), so a
program the JAX front end builds runs in the port from its JSON.
"""
from __future__ import annotations

import contextlib
from typing import List

from .. import unique_name
from ..core.program import Variable
from ..layer_helper import LayerHelper


class DynamicRNN:
    """A variable-length RNN over ragged batches; the step logic is layer
    code written inside ``rnn.block()``."""

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.main_program = self.helper.main_program
        self.parent_block = self.main_program.current_block()
        self.sub_block = None
        self._step_inputs = []     # (outer_name, inner_name)
        self._static_inputs = []   # (outer_name, inner_name)
        self._memories = []        # spec dicts
        self._mem_vars = {}        # inner step var name -> spec
        self._outputs = []         # in-block var names
        self._out_vars: List[Variable] = []
        self._first_step_input = None
        self._dynamic = True

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be entered once")
        self.sub_block = self.main_program.create_block()
        self.status = DynamicRNN.IN_RNN
        yield
        self.main_program.rollback()
        self.status = DynamicRNN.AFTER_RNN
        if not self._outputs:
            raise ValueError("rnn.output must be called inside the block")
        for name in self._outputs:
            inner = self.sub_block.var(name)
            out = self.parent_block.create_var(
                name=unique_name.generate(self.helper.name + ".out"),
                dtype=inner.dtype, lod_level=1)
            if inner.shape and self._first_step_input is not None:
                fsi = self.parent_block.var(self._first_step_input)
                t = fsi.shape[1] if fsi.shape and len(fsi.shape) > 1 else -1
                out.desc.shape = (inner.shape[0], t) + tuple(inner.shape[1:])
            self._out_vars.append(out)
        self.parent_block.append_op(
            type="dynamic_rnn",
            inputs={"StepInputs": [o for o, _ in self._step_inputs],
                    "StaticInputs": [o for o, _ in self._static_inputs],
                    "InitMems": [m["init"] for m in self._memories
                                 if m.get("init")]},
            outputs={"Out": self._out_vars},
            attrs={"sub_block": self.sub_block.idx,
                   "step_inputs": list(self._step_inputs),
                   "static_inputs": list(self._static_inputs),
                   "memories": list(self._memories),
                   "output_vars": list(self._outputs),
                   "dynamic": self._dynamic})

    def _assert_in_rnn(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{method} must be invoked inside rnn.block()")

    def step_input(self, x):
        self._assert_in_rnn("step_input")
        v = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".step_in"),
            dtype=x.dtype)
        if x.shape and len(x.shape) >= 2:
            v.desc.shape = (x.shape[0],) + tuple(x.shape[2:])
        if self._first_step_input is None:
            self._first_step_input = x.name
        self._step_inputs.append((x.name, v.name))
        return v

    def static_input(self, x):
        self._assert_in_rnn("static_input")
        v = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".static_in"),
            dtype=x.dtype, lod_level=x.lod_level)
        v.desc.shape = x.shape
        self._static_inputs.append((x.name, v.name))
        return v

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_rnn("memory")
        v = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".mem"),
            dtype=init.dtype if init is not None else dtype)
        spec = {"step": v.name, "new": v.name,  # identity until update_memory
                "init": init.name if init is not None else None,
                "value": value, "shape": list(shape) if shape else None,
                "dtype": (init.dtype if init is not None else dtype)}
        if init is not None and init.shape:
            v.desc.shape = init.shape
        elif shape:
            v.desc.shape = (-1,) + tuple(shape)
        self._memories.append(spec)
        self._mem_vars[v.name] = spec
        return v

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn("update_memory")
        spec = self._mem_vars.get(ex_mem.name)
        if spec is None:
            raise ValueError("update_memory: first arg must come from "
                             "rnn.memory")
        spec["new"] = new_mem.name

    def output(self, *outputs):
        self._assert_in_rnn("output")
        for o in outputs:
            self._outputs.append(o.name)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("rnn() is only valid after the rnn.block() "
                             "scope")
        return self._out_vars[0] if len(self._out_vars) == 1 \
            else self._out_vars


class StaticRNN(DynamicRNN):
    """Fixed-length steps (no length masking)."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self._dynamic = False

    def step(self):
        return self.block()


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", input=x)
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def array_write(x, i, array=None):
    """Tensor-array write.  An array is a Python list in the env; inside
    an RNN prefer rnn.output."""
    from ..core.types import VarType
    helper = LayerHelper("array_write", input=x)
    if array is None:
        array = helper.block.create_var(
            name=unique_name.generate("tensor_array"),
            type=VarType.LOD_TENSOR_ARRAY, dtype=x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", input=array)
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length", input=array)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def _outer_uses(sub_block):
    """(reads, writes) of vars that live outside ``sub_block``, resolved
    through the whole ancestor chain, so writes to grandparent or global
    vars from nested constructs are carried."""
    local = sub_block.vars

    def is_outer(n):
        if n in local:
            return False
        parent = sub_block.parent_block
        return parent is not None and parent.has_var(n)

    reads, writes, seen_w = [], [], set()
    seen_r = set()
    for op in sub_block.ops:
        for n in op.desc.input_names():
            if n not in seen_r and is_outer(n):
                seen_r.add(n)
                reads.append(n)
        for n in op.desc.output_names():
            if n not in seen_w and is_outer(n):
                seen_w.add(n)
                writes.append(n)
    return reads, writes


class While:
    """Run a sub-block until ``cond`` is False.

    The loop carries every outer var the block writes (found from the
    sub-block's op outputs), so updates made inside the block, the
    condition's included, persist across trips and out of the loop.  The
    ``while`` rule (ops/control_ops.py) runs it as a host loop.
    """

    def __init__(self, cond, is_test=False, name=None, max_trip_count=None):
        """``max_trip_count``: an optional bound on the trips.  A bounded
        loop gives the same result and is reverse-differentiable (the
        JAX rule's masked ``lax.scan``); an unbounded one refuses a
        gradient, as ``lax.while_loop`` does."""
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.main_program = self.helper.main_program
        self.parent_block = self.main_program.current_block()
        self.sub_block = None
        self.max_trip_count = max_trip_count

    @contextlib.contextmanager
    def block(self):
        self.sub_block = self.main_program.create_block()
        yield
        self.main_program.rollback()
        reads, carry = _outer_uses(self.sub_block)
        carry_vars = [self.parent_block.var(n) for n in carry]
        attrs = {"sub_block": self.sub_block.idx,
                 "carry_vars": list(carry)}
        if self.max_trip_count is not None:
            attrs["max_trip_count"] = int(self.max_trip_count)
        self.parent_block.append_op(
            type="while",
            inputs={"Condition": [self.cond_var],
                    "X": [n for n in reads if n not in set(carry)]},
            outputs={"Out": carry_vars},
            attrs=attrs)


class IfElse:
    """Per-row branch routing.

    Both branches run on the whole batch and their outputs merge row-wise
    with a select (ops/control_ops.py if_else): no dynamic shapes.  This
    matches the reference, which splits the rows, only when the branch
    ops are row-independent (elementwise, fc, activations); a cross-row
    op inside a branch (mean, batch_norm, sequence pooling) sees rows the
    reference would have left out, so apply reductions after the merge.
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("if_else", name=name)
        self.cond_var = cond
        self.main_program = self.helper.main_program
        self.parent_block = self.main_program.current_block()
        self._blocks = {}          # "true"/"false" -> block
        self._inputs = {"true": [], "false": []}
        self._outputs = {"true": [], "false": []}
        self._in_branch = None
        self._out_vars = None

    @contextlib.contextmanager
    def _branch(self, which):
        self._blocks[which] = self.main_program.create_block()
        self._in_branch = which
        yield
        self.main_program.rollback()
        self._in_branch = None

    def true_block(self):
        return self._branch("true")

    def false_block(self):
        return self._branch("false")

    def input(self, x):
        if self._in_branch is None:
            raise ValueError("ie.input() must be called inside a branch block")
        v = self._blocks[self._in_branch].create_var(
            name=unique_name.generate(self.helper.name + ".in"),
            dtype=x.dtype)
        v.desc.shape = x.shape
        self._inputs[self._in_branch].append((x.name, v.name))
        return v

    def output(self, *outs):
        if self._in_branch is None:
            raise ValueError("ie.output() must be called inside a branch block")
        for o in outs:
            self._outputs[self._in_branch].append(o.name)

    def __call__(self):
        if len(self._outputs["true"]) != len(self._outputs["false"]):
            raise ValueError("true/false branches must produce the same "
                             "number of outputs")
        outs = []
        for name in self._outputs["true"]:
            inner = self._blocks["true"].var(name)
            v = self.parent_block.create_var(
                name=unique_name.generate(self.helper.name + ".out"),
                dtype=inner.dtype)
            v.desc.shape = inner.shape
            outs.append(v)
        self.parent_block.append_op(
            type="if_else",
            inputs={"Cond": [self.cond_var],
                    "X": [o for o, _ in (self._inputs["true"]
                                         + self._inputs["false"])]},
            outputs={"Out": outs},
            attrs={"true_block": self._blocks["true"].idx,
                   "false_block": self._blocks["false"].idx,
                   "true_inputs": list(self._inputs["true"]),
                   "false_inputs": list(self._inputs["false"]),
                   "true_outputs": list(self._outputs["true"]),
                   "false_outputs": list(self._outputs["false"])})
        self._out_vars = outs
        return outs[0] if len(outs) == 1 else outs


class ConditionalBlock:
    """Run a block iff a scalar condition is true; the vars the block
    assigns keep their prior values otherwise."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        self.helper = LayerHelper("conditional_block", name=name)
        self.cond_var = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        self.main_program = self.helper.main_program
        self.parent_block = self.main_program.current_block()
        self.sub_block = None

    @contextlib.contextmanager
    def block(self):
        self.sub_block = self.main_program.create_block()
        yield
        self.main_program.rollback()
        _, written = _outer_uses(self.sub_block)
        self.parent_block.append_op(
            type="conditional_block",
            inputs={"Cond": [self.cond_var]},
            outputs={"Out": [self.parent_block.var(n) for n in written]},
            attrs={"sub_block": self.sub_block.idx,
                   "out_vars": list(written)})


def lod_rank_table(x, level=0):
    """The rows' order by length, longest first.  Its @SEQ_LEN companion
    carries the lengths (ops/lod_ops.py)."""
    helper = LayerHelper("lod_rank_table", input=x)
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"level": level})
    out.desc.shape = (x.shape[0],) if x.shape else (-1,)
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len", input=rank_table)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    out.desc.shape = (1,)
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    out.desc.shape = x.shape
    return out


def lod_tensor_to_array(x, table=None):
    """Padded [B,T,...] -> tensor array of T timestep slices."""
    from ..core.types import VarType
    helper = LayerHelper("lod_tensor_to_array", input=x)
    arr = helper.block.create_var(
        name=unique_name.generate("lod_tensor_to_array"),
        type=VarType.LOD_TENSOR_ARRAY, dtype=x.dtype)
    inputs = {"X": [x]}
    if table is not None:
        inputs["RankTable"] = [table]
    helper.append_op(type="lod_tensor_to_array", inputs=inputs,
                     outputs={"Out": [arr]})
    return arr


def array_to_lod_tensor(x, table=None):
    helper = LayerHelper("array_to_lod_tensor", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if table is not None:
        inputs["RankTable"] = [table]
    helper.append_op(type="array_to_lod_tensor", inputs=inputs,
                     outputs={"Out": [out]})
    return out


def shrink_memory(x, i, table):
    """shrink_rnn_memory: the rows whose sequence has ended are masked to
    zero (ops/lod_ops.py)."""
    helper = LayerHelper("shrink_memory", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    out.desc.shape = x.shape
    return out


def split_lod_tensor(input, mask, level=0):
    helper = LayerHelper("split_lod_tensor", input=input)
    out_true = helper.create_variable_for_type_inference(input.dtype)
    out_false = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="split_lod_tensor",
                     inputs={"X": [input], "Mask": [mask]},
                     outputs={"OutTrue": [out_true],
                              "OutFalse": [out_false]},
                     attrs={"level": level})
    out_true.desc.shape = input.shape
    out_false.desc.shape = input.shape
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    helper = LayerHelper("merge_lod_tensor", input=x)
    out = helper.create_variable_for_type_inference(in_true.dtype)
    helper.append_op(type="merge_lod_tensor",
                     inputs={"InTrue": [in_true], "InFalse": [in_false],
                             "X": [x], "Mask": [mask]},
                     outputs={"Out": [out]}, attrs={"level": level})
    out.desc.shape = in_true.shape
    return out


def get_places(device_count=None, device_type=None):
    """The devices ParallelDo would span: the CUDA devices (the CPU when
    there is none, or for ``device_type="CPU"``)."""
    import torch
    if device_type == "CPU" or not torch.cuda.is_available():
        devs = [torch.device("cpu")]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_count:
        devs = devs[:device_count]
    return devs


class ParallelDo:
    """A data-parallel sub-block.  The reference splits the batch across
    places and merges the gradients; here, as in the JAX package, the
    block runs once over the whole batch, which gives the same results
    and gradients.  Data parallelism waits for queue A item 4."""

    def __init__(self, places, use_nccl=False, name=None):
        self.helper = LayerHelper("parallel_do", name=name)
        self.places = places
        self.main_program = self.helper.main_program
        self.parent_block = self.main_program.current_block()
        self.sub_block = None
        self._input_pairs = []
        self._outputs = []
        self._out_vars = None

    @contextlib.contextmanager
    def do(self):
        self.sub_block = self.main_program.create_block()
        yield
        self.main_program.rollback()
        outs = []
        for name in self._outputs:
            inner = self.sub_block.var(name)
            v = self.parent_block.create_var(
                name=unique_name.generate(self.helper.name + ".out"),
                dtype=inner.dtype)
            v.desc.shape = inner.shape
            outs.append(v)
        self.parent_block.append_op(
            type="parallel_do",
            inputs={"X": [o for o, _ in self._input_pairs]},
            outputs={"Out": outs},
            attrs={"sub_block": self.sub_block.idx,
                   "input_pairs": list(self._input_pairs),
                   "output_vars": list(self._outputs)})
        self._out_vars = outs

    def read_input(self, x):
        v = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".in"),
            dtype=x.dtype)
        v.desc.shape = x.shape
        self._input_pairs.append((x.name, v.name))
        return v

    def write_output(self, o):
        self._outputs.append(o.name)

    def __call__(self):
        return (self._out_vars[0] if len(self._out_vars) == 1
                else self._out_vars)


class Switch:
    """Build-time case dispatch: ``case`` and ``default`` scopes, as the
    JAX package's (which emits no op of its own)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []          # (cond_var_name or None, assigns)

    @contextlib.contextmanager
    def case(self, condition):
        self._current = ("case", condition)
        yield

    @contextlib.contextmanager
    def default(self):
        self._current = ("default", None)
        yield


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """A ``print`` op: prints the message and the value when it runs."""
    helper = LayerHelper("print", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"first_n": first_n, "message": message or "",
                            "summarize": summarize})
    out.desc.shape = input.shape
    return out
