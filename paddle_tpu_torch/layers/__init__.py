"""Layers DSL (counterpart of ``paddle_tpu/layers``): the layer functions,
each appending ops to the current block."""
from .. import ops as _ops  # registers the op rules  # noqa: F401

from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
from .ops import *         # noqa: F401,F403
from .sequence import *    # noqa: F401,F403
from .structured import *  # noqa: F401,F403
from .misc import *        # noqa: F401,F403
from .control_flow import (DynamicRNN, StaticRNN, Switch, Print,  # noqa: F401
                           increment, array_write, array_read, array_length,
                           While, IfElse, ConditionalBlock, ParallelDo,
                           get_places, lod_rank_table, max_sequence_len,
                           reorder_lod_tensor_by_rank, lod_tensor_to_array,
                           array_to_lod_tensor, shrink_memory,
                           split_lod_tensor, merge_lod_tensor)
# io after the star-imports: the reader ops `batch` and `shuffle` are
# the layers' names for them, as in the JAX package
from .io import (data, Reader, EOFException, open_recordio_file,  # noqa: F401
                 open_files, batch, shuffle, double_buffer, multi_pass,
                 read_file, ListenAndServ, Send)
from .learning_rate_scheduler import (  # noqa: F401
    autoincreased_step_counter, exponential_decay, inverse_time_decay,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
from . import (control_flow, detection, io,  # noqa: F401
               learning_rate_scheduler, misc, nn, ops, sequence, structured,
               tensor)
from .detection import (prior_box, iou_similarity, box_coder,  # noqa: F401
                        bipartite_match, target_assign, multiclass_nms,
                        detection_output, detection_map, ssd_loss,
                        multi_box_head)
