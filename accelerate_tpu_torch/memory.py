"""Out-of-memory retry: the port of `accelerate_tpu.memory`.

`find_executable_batch_size` calls the wrapped function with a starting
batch size and, whenever the device runs out of memory, releases what it
can and calls it again with half the batch. `should_reduce_batch_size`
recognizes ``torch.cuda.OutOfMemoryError``, the CPU allocator's failure
(``RuntimeError: ... DefaultCPUAllocator: can't allocate memory``, or a
``MemoryError``) and the reference's markers. `release_memory` drops the
references it is given and empties the CUDA caching allocator.
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Any, Callable

import torch

_MARKERS = ("CUDA out of memory", "DefaultCPUAllocator: can't allocate memory",
            "RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM")


def should_reduce_batch_size(exception: BaseException) -> bool:
    """True for a device or host out-of-memory error."""
    if isinstance(exception, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    return isinstance(exception, RuntimeError) and any(m in str(exception) for m in _MARKERS)


def clear_device_cache(garbage_collection: bool = False) -> None:
    """Collect garbage if asked, then hand the CUDA caching allocator's free
    blocks back to the driver."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def release_memory(*objects: Any) -> Any:
    """``None`` for each object (assign the result over your references),
    after a collection and `clear_device_cache`."""
    cleared = [None for _ in objects]
    clear_device_cache(garbage_collection=True)
    return cleared if len(cleared) != 1 else cleared[0]


def find_executable_batch_size(function: Callable | None = None,
                               starting_batch_size: int = 128) -> Callable:
    """Decorator: ``function(batch_size, *args, **kwargs)``, halving
    ``batch_size`` after each out-of-memory error until a call returns
    (RuntimeError at zero); ``wrapper.batch_size`` keeps the size that ran.
    The batch size must be the function's first argument."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)
    params = list(inspect.signature(function).parameters)
    if not params or params[0] == "self" and len(params) < 2:
        raise TypeError(f"Batch-size argument must be first in {function.__name__}'s signature.")

    @functools.wraps(function)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        batch_size = wrapper.batch_size
        while True:
            if batch_size == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                result = function(batch_size, *args, **kwargs)
                wrapper.batch_size = batch_size
                return result
            except (RuntimeError, MemoryError) as e:  # what an allocator raises
                if not should_reduce_batch_size(e):
                    raise
                # the traceback holds the failed attempt's frames, and with
                # them its tensors: drop it before releasing the cache
                e.__traceback__ = None
                del e
                clear_device_cache(garbage_collection=True)
                batch_size //= 2

    wrapper.batch_size = starting_batch_size
    return wrapper
