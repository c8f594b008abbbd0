"""The port's core: places and dtypes, the Program IR, the op registry,
scopes, the interpreter, autodiff and the executor."""
from . import backward, executor, lowering, program, registry, scope  # noqa: F401
from .. import ops as _ops  # registers the op rules  # noqa: F401
from .backward import append_backward  # noqa: F401
from .executor import Executor  # noqa: F401
from .place import CPUPlace, CUDAPlace  # noqa: F401
from .program import (Block, Operator, Parameter, Program,  # noqa: F401
                      Variable, default_main_program,
                      default_startup_program, program_guard,
                      reset_default_programs)
from .registry import OpRegistry, register_op  # noqa: F401
from .scope import Scope, global_scope, scope_guard  # noqa: F401
from .types import VarType, convert_dtype, to_torch_dtype  # noqa: F401
