"""Reader creators and decorators (counterpart of ``paddle_tpu/reader``)."""
from .decorator import (map_readers, buffered, compose, chain,  # noqa: F401
                        shuffle, firstn, xmap_readers, multiprocess_reader,
                        ComposeNotAligned, cache, device_prefetch,
                        resumable, StackedBatch, stage_to_device)
from . import creator  # noqa: F401
