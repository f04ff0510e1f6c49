"""The port's out-of-memory retry (`accelerate_tpu_torch.memory`) and
multi-process logging (`accelerate_tpu_torch.logging`), on the CPU: the
reference's `tests/test_memory_logging.py`, case for case, then the same
scripts through both packages, and a real allocator failure."""

import logging

import pytest
import torch

from accelerate_tpu_torch.logging import get_logger
from accelerate_tpu_torch.memory import (
    clear_device_cache,
    find_executable_batch_size,
    release_memory,
    should_reduce_batch_size,
)
from torch_threads import one_torch_thread  # noqa: F401


class TestFindExecutableBatchSize:
    def test_halves_until_fit(self):
        seen = []

        @find_executable_batch_size(starting_batch_size=128)
        def train(batch_size):
            seen.append(batch_size)
            if batch_size > 16:
                raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
            return batch_size

        assert train() == 16
        assert seen == [128, 64, 32, 16]
        assert train.batch_size == 16

    def test_extra_args_forwarded(self):
        @find_executable_batch_size(starting_batch_size=8)
        def train(batch_size, a, b=2):
            return batch_size + a + b

        assert train(1, b=3) == 12

    def test_non_oom_errors_propagate(self):
        @find_executable_batch_size(starting_batch_size=8)
        def train(batch_size):
            raise ValueError("unrelated")

        with pytest.raises(ValueError, match="unrelated"):
            train()

    def test_gives_up_at_zero(self):
        @find_executable_batch_size(starting_batch_size=2)
        def train(batch_size):
            raise RuntimeError("OOM")

        with pytest.raises(RuntimeError, match="reached zero"):
            train()

    def test_missing_batch_size_arg_rejected(self):
        with pytest.raises(TypeError):  # raised at decoration time

            @find_executable_batch_size(starting_batch_size=4)
            def bad():
                return 0

    def test_should_reduce_markers(self):
        assert should_reduce_batch_size(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
        assert should_reduce_batch_size(MemoryError("Out of memory"))
        assert should_reduce_batch_size(torch.cuda.OutOfMemoryError("CUDA out of memory."))
        assert not should_reduce_batch_size(ValueError("shape mismatch"))
        assert not should_reduce_batch_size(RuntimeError("mat1 and mat2 shapes cannot be "
                                                         "multiplied"))


def test_a_real_cpu_allocator_failure_halves_the_batch():
    """The CPU allocator's own error (petabytes asked for) is recognized,
    and the search goes on until an allocation fits."""
    seen = []

    @find_executable_batch_size(starting_batch_size=128)
    def train(batch_size):
        seen.append(batch_size)
        return torch.empty(batch_size * 2**50 if batch_size > 16 else batch_size,
                           dtype=torch.uint8).numel()

    assert train() == 16 and seen == [128, 64, 32, 16]


def test_same_batch_sizes_as_the_reference():
    pytest.importorskip("jax")
    from accelerate_tpu import memory as jax_memory

    def run(pkg):
        seen = []

        @pkg.find_executable_batch_size(starting_batch_size=100)
        def train(batch_size, limit):
            seen.append(batch_size)
            if batch_size > limit:
                raise RuntimeError("out of memory")
            return batch_size

        return train(13), seen

    import accelerate_tpu_torch.memory as port_memory

    assert run(port_memory) == run(jax_memory) == (12, [100, 50, 25, 12])


def test_release_memory_clears_references():
    a, b = object(), object()
    a2, b2 = release_memory(a, b)
    assert a2 is None and b2 is None
    assert release_memory(object()) is None
    clear_device_cache(garbage_collection=True)  # no CUDA here: a collection only


class TestMultiProcessLogger:
    def _capture(self, logger, level=logging.INFO):
        records = []

        class Sink(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        logger.logger.addHandler(Sink())
        if level is not None:
            logger.logger.setLevel(level)
        return records

    def test_main_process_logs_by_default(self):
        logger = get_logger("torch_t.main")
        records = self._capture(logger)
        logger.info("hello")
        logger.info("everywhere", main_process_only=False)
        assert records == ["hello", "everywhere"]  # one process is the main process

    def test_level_from_env(self, monkeypatch):
        root_before = logging.getLogger().level
        monkeypatch.setenv("ACCELERATE_TPU_LOG_LEVEL", "ERROR")
        try:
            logger = get_logger("torch_t.env")
            assert logger.logger.level == logging.ERROR
            records = self._capture(logger, level=None)
            logger.info("dropped")
            logger.error("kept")
            assert records == ["kept"]
        finally:
            logging.getLogger().setLevel(root_before)
            logging.getLogger("torch_t.env").setLevel(logging.NOTSET)

    def test_in_order_stamps_rank(self):
        logger = get_logger("torch_t.order")
        records = self._capture(logger)
        logger.info("msg", in_order=True)
        assert records == ["[rank 0] msg"]

    def test_records_name_the_caller(self):
        logger = get_logger("torch_t.caller")
        seen = []

        class Sink(logging.Handler):
            def emit(self, record):
                seen.append(record.funcName)

        logger.logger.addHandler(Sink())
        logger.logger.setLevel(logging.INFO)
        logger.warning("where")
        assert seen == ["test_records_name_the_caller"]
