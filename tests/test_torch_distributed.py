"""The port's multi-process runtime on gloo processes on the CPU, against the
reference's semantics.

One world of 2 ranks and one of 4 (`tests/torch_world.py`) start together
and run every check of `tests/torch_dist_worker.py`: the topology and the
barriers, `split_between_processes` with and without padding, every
collective of `utils.operations` (ragged gathers, broadcasts from a nonzero
rank, the debug-mode shape check), RNG seeding and synchronization, the
loaders (`BatchSamplerShard` through `prepare_data_loader`, index for index
against the reference's class at the same ``num_processes`` and
``process_index``; `IterableDatasetShard`; `DataLoaderDispatcher`; global
batches sliced by rank; `skip_first_batches`), ``gather_for_metrics`` over a
ragged eval set, the broadcast at ``prepare``, ``no_sync``,
``join_uneven_inputs`` in both loops, the triggers, ``save_state`` /
``load_state``, an fp16 overflow on one rank (every rank skips), and the
trackers and ``save`` writing from the main process only. The
parametrised cases read what each world recorded.

In this process: with no launcher environment an `Accelerator` makes no
process group, and ``WORLD_SIZE`` without ``MASTER_ADDR`` raises.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from accelerate_tpu.data_loader import BatchSamplerShard as JaxBatchSamplerShard  # noqa: E402
from accelerate_tpu.data_loader import IterableDatasetShard as JaxIterableDatasetShard  # noqa: E402
from accelerate_tpu.state import PartialState as JaxPartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.data_loader import BatchSamplerShard  # noqa: E402
from accelerate_tpu_torch.state import PartialState  # noqa: E402
from torch_dist_worker import LOADER_CASES, SPLIT_ARRAYS  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401
from torch_world import ROOT, World, result  # noqa: E402

SIZES = (2, 4)
# the training checks: fp32 arithmetic of a 4x3 linear layer in another order
TRAIN_ATOL = 1e-6


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    dirs = {n: tmp_path_factory.mktemp(f"world{n}") for n in SIZES}
    started = {n: World(ROOT / "tests" / "torch_dist_worker.py", "run", (str(d),), n, d)
               for n, d in dirs.items()}
    return {n: w.wait() for n, w in started.items()}


def _all(world, name):
    return [result(world, r, name) for r in range(len(world))]


# ------------------------------------------------------------- in process
def test_no_launcher_environment_means_no_process_group(monkeypatch):
    import torch.distributed as dist

    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    acc = Accelerator(device="cpu")
    assert not dist.is_initialized()
    assert acc.num_processes == 1 and acc.process_index == 0 and not acc.use_distributed
    assert acc.distributed_type == "NO" and acc.mesh.shape["data"] == 1
    assert acc.mesh.device_mesh is None


def test_world_size_without_master_addr_raises(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        Accelerator(device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("split,even,drop", [(False, True, False), (False, False, False),
                                             (True, True, False), (True, False, False),
                                             (False, True, True)])
def test_batch_sampler_shard_is_the_reference_s(n, split, even, drop):
    for size in (1, 3, 16, 17, 21, 33):
        for bs in (4, 8):
            for rank in range(n):
                make = lambda: torch.utils.data.BatchSampler(  # noqa: E731
                    torch.utils.data.SequentialSampler(range(size)), bs, drop)
                got = BatchSamplerShard(make(), n, rank, split, even)
                want = JaxBatchSamplerShard(make(), n, rank, split, even)
                assert list(got) == list(want), (size, bs, rank)
                assert len(got) == len(want)


# ------------------------------------------------------------ the worlds
@pytest.mark.parametrize("n", SIZES)
def test_topology(worlds, n):
    for r, top in enumerate(_all(worlds[n], "topology")):
        assert top == {"rank": r, "world": n, "local": r, "distributed_type": "SPMD",
                       "mesh": {"data": n, "fsdp": 1, "stage": 1, "sequence": 1, "tensor": 1},
                       "use_distributed": True, "device": "cpu", "main": r == 0,
                       "last": r == n - 1, "backend": "gloo", "num_devices": n}


@pytest.mark.parametrize("n", SIZES)
def test_main_process_first_runs_main_first(worlds, n):
    assert _all(worlds[n], "main_process_first") == [True] * n


def _reference_split(inputs, n, r, pad):
    """The reference's `PartialState.split_between_processes` at rank ``r``
    of ``n``, on a stand-in state."""
    stand_in = SimpleNamespace(num_processes=n, process_index=r)
    with JaxPartialState.split_between_processes(stand_in, inputs, apply_padding=pad) as piece:
        return piece


def _as_list(piece):
    return piece.tolist() if isinstance(piece, np.ndarray) else list(piece)


@pytest.mark.parametrize("n", SIZES)
def test_split_between_processes(worlds, n):
    """Each rank's slice equals the reference's: arrays and tensors (held to
    the reference's numpy branch) repeat the slice's last element and leave
    an empty slice empty; lists, tuples and dict values repeat the input's
    last element."""
    for r, got in enumerate(_all(worlds[n], "split_between_processes")):
        for pad in (False, True):
            assert got[f"list_{pad}"] == _reference_split(list(range(7)), n, r, pad)
            tup = _reference_split(tuple(range(7)), n, r, pad)
            assert got[f"tuple_{pad}"] == (tuple(tup) if pad else tup)
            assert type(got[f"tuple_{pad}"]) is tuple
            want = _reference_split({"a": list(range(5)), "b": list("abcde")}, n, r, pad)
            assert got[f"dict_{pad}"] == {k: list(v) for k, v in want.items()}
            for name, data in SPLIT_ARRAYS.items():
                want = _as_list(_reference_split(np.asarray(data), n, r, pad))
                assert got[f"numpy_{name}_{pad}"] == want, (name, r, pad)
                assert got[f"tensor_{name}_{pad}"] == want, (name, r, pad)
                assert got[f"list_{name}_{pad}"] == _reference_split(list(data), n, r, pad)


def _port_split(inputs, n, r, pad):
    stand_in = SimpleNamespace(num_processes=n, process_index=r)
    with PartialState.split_between_processes(stand_in, inputs, apply_padding=pad) as piece:
        return piece


def test_split_pads_arrays_with_the_slice_s_last_element():
    """At 3 ranks over ``np.arange(7)`` rank 1 takes ``[3, 4]`` padded with
    its own 4; at 4 ranks over ``np.arange(2)`` the last ranks' slices stay
    empty, while a list repeats the input's last element."""
    assert _port_split(np.arange(7), 3, 1, True).tolist() == [3, 4, 4]
    assert _port_split(torch.arange(7), 3, 1, True).tolist() == [3, 4, 4]
    assert _port_split(np.arange(2), 4, 3, True).tolist() == []
    assert _port_split(torch.arange(2), 4, 3, True).tolist() == []
    assert _port_split(list(range(2)), 4, 3, True) == [1]


@pytest.mark.parametrize("n", (3, 5))
def test_split_between_processes_at_other_world_sizes(n):
    """The same rule at world sizes no world of this file runs, in process."""
    for r in range(n):
        for pad in (False, True):
            for data in SPLIT_ARRAYS.values():
                want = _as_list(_reference_split(np.asarray(data), n, r, pad))
                assert _port_split(np.asarray(data), n, r, pad).tolist() == want
                assert _port_split(torch.as_tensor(data), n, r, pad).tolist() == want
                assert _port_split(list(data), n, r, pad) == _reference_split(list(data), n, r, pad)


@pytest.mark.parametrize("n", SIZES)
def test_rng_types_give_every_rank_rank_0_s_state_at_each_epoch(worlds, n):
    """A `DataLoaderShard` with ``rng_types`` gives every rank rank 0's
    Python, numpy and torch states as each epoch starts (the reference's
    rule, `data_loader.py:521-522`): two epochs' draws on every rank are
    rank 0's, which are one process's seeded as rank 0 was."""
    import random

    from accelerate_tpu_torch.utils.random import set_seed

    set_seed(100)
    want = [[random.random(), float(np.random.rand()), torch.rand(1).item()] for _ in range(2)]
    assert _all(worlds[n], "rng_types_epochs") == [want] * n


COLLECTIVES = ["gather_equal", "gather_ragged", "gather_scalar", "gather_numpy_nested",
               "gather_object", "broadcast_last", "broadcast_nested_numpy",
               "broadcast_keeps_input", "broadcast_object_list_last", "pad_dim0",
               "pad_dim1_first", "reduce_sum", "reduce_mean_scale", "pad_input_tensors",
               "consolidate_on_main", "verify_operation"]


def _want(name, n, r):
    ranks = range(n)
    return {
        "gather_equal": [[float(i)] * 3 for i in ranks for _ in range(2)],
        "gather_ragged": [float(x) for i in ranks for x in range(i + 1)],
        "gather_scalar": [2.0 * i for i in ranks],
        "gather_numpy_nested": {"a": [x for i in ranks for x in (i, i + 1)], "t": "ndarray",
                                "b": list(ranks)},
        "gather_object": [x for i in ranks for x in (f"proc{i}", {"r": i})],
        "broadcast_last": [float(n - 1 + 5)] * 3,
        "broadcast_nested_numpy": [[1, 1], "ndarray"],
        "broadcast_keeps_input": [float(r)] * 2,
        "broadcast_object_list_last": [f"payload{n - 1}", (n - 1) * 10],
        "pad_dim0": [float(x) for x in range(r + 1)] + [0.0] * (n - 1 - r),
        "pad_dim1_first": [[-1.0] * (n - 1 - r) + [1.0] * (r + 1)] * 2,
        "reduce_sum": [sum(1.0 + i for i in ranks), 2.0 * n],
        "reduce_mean_scale": [2.0 * sum(1.0 + i for i in ranks) / n],
        "pad_input_tensors": list(range(5)) + [4] * ((-5) % n),
        "consolidate_on_main": [1.0, 1.0] if r == 0 else None,
    }[name]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective(worlds, n, name):
    for r, got in enumerate(_all(worlds[n], name)):
        if name == "verify_operation":
            assert "differ across processes" in got
            for i in range(n):
                assert f"process {i}: (({i + 1},)," in got
            continue
        assert got == _want(name, n, r), (r, got)


@pytest.mark.parametrize("n", SIZES)
def test_rng_seeding_and_synchronization(worlds, n):
    got = _all(worlds[n], "rng")
    assert len({tuple(g["own"]) for g in got}) == n  # device_specific: each rank its own
    assert all(g["synced"] == got[0]["synced"] for g in got)  # rank 0's state everywhere


def _reference_shard(size, bs, split, even, drop, n, r):
    sampler = torch.utils.data.BatchSampler(torch.utils.data.SequentialSampler(range(size)),
                                            bs, drop)
    return [list(b) for b in JaxBatchSamplerShard(sampler, n, r, split, even)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", LOADER_CASES, ids=str)
def test_prepared_loader_indices_are_the_reference_s(worlds, n, case):
    size, bs, split, even, drop = case
    total = bs if split else bs * n
    want_remainder = size % total if (size % total and not drop) else -1
    for r, got in enumerate(_all(worlds[n], "batch_sampler_shard")):
        ids, remainder = got[case]
        assert ids == _reference_shard(size, bs, split, even, drop, n, r)
        assert remainder == want_remainder


@pytest.mark.parametrize("n", SIZES)
def test_iterable_dataset_shard_is_the_reference_s(worlds, n):
    for r, got in enumerate(_all(worlds[n], "iterable_dataset_shard")):
        for size, bs, split in ((17, 4, False), (16, 4, True), (5, 4, False)):
            direct = list(JaxIterableDatasetShard(range(size), bs, n, r, split_batches=split))
            assert got[("direct", size, bs, split)] == direct
            chunked = list(JaxIterableDatasetShard(range(size), bs if split else bs * n, n, r,
                                                   split_batches=True))
            assert [i for b in got[(size, bs, split)] for i in b] == chunked


def _sliced(ids, n, r):
    per = -(-len(ids) // n)
    full = [ids[i % len(ids)] for i in range(per * n)]
    return full[r * per:(r + 1) * per]


@pytest.mark.parametrize("n", SIZES)
def test_dispatcher_slices_rank_zero_s_batches(worlds, n):
    batches = [list(range(i, min(i + 6, 19))) for i in range(0, 19, 6)]
    for r, got in enumerate(_all(worlds[n], "dispatcher")):
        assert got["batches"] == [(_sliced(b, n, r), i == len(batches) - 1)
                                  for i, b in enumerate(batches)]
        assert got["remainder"] == (1 if n > 1 else -1)


@pytest.mark.parametrize("n", SIZES)
def test_global_batches_slice_by_rank_and_skip(worlds, n):
    batches = [list(range(i * 6, i * 6 + 6)) for i in range(3)] + [list(range(18, 23))]
    for r, got in enumerate(_all(worlds[n], "global_batch_slices")):
        assert got["slices"] == [_sliced(b, n, r) for b in batches]
        assert got["remainder"] == 5
        assert got["skipped"] == [_sliced(b, n, r) for b in batches[2:]]


@pytest.mark.parametrize("n", SIZES)
def test_gather_for_metrics_counts_a_ragged_eval_set_once(worlds, n):
    for got in _all(worlds[n], "gather_for_metrics"):
        assert [x for b in got["plain"] for x in b] == [float(i) for i in range(37)]
        assert [x for b in got["torch"] for x in b] == list(range(37))
        assert got["objects"] == list(range(37))


def _linear_params():
    torch.manual_seed(0)  # rank 0's, which prepare broadcasts
    m = torch.nn.Linear(4, 3)
    return [p.detach().clone() for p in m.parameters()]


def _batches(n):
    g = torch.Generator().manual_seed(3)
    xs, ys = torch.randn(6, n * 2, 4, generator=g), torch.randn(6, n * 2, 3, generator=g)
    return [[{"x": xs[i, r * 2:(r + 1) * 2], "y": ys[i, r * 2:(r + 1) * 2]} for i in range(6)]
            for r in range(n)]


def _loss_and_grads(params, batch):
    w, b = (p.clone().requires_grad_(True) for p in params)
    loss = ((batch["x"] @ w.T + b - batch["y"]) ** 2).mean()
    return loss.item(), torch.autograd.grad(loss, [w, b])


@pytest.mark.parametrize("n", SIZES)
def test_prepare_broadcasts_rank_zero_s_parameters(worlds, n):
    want = _linear_params()
    for got in _all(worlds[n], "prepare_broadcasts_rank0"):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", SIZES)
def test_no_sync_holds_the_all_reduce_until_the_next_boundary(worlds, n):
    params, data = _linear_params(), _batches(n)
    sums = [[a + b for a, b in zip(_loss_and_grads(params, data[r][0])[1],
                                   _loss_and_grads(params, data[r][1])[1])] for r in range(n)]
    mean_w = sum(s[0] for s in sums) / n
    for r, got in enumerate(_all(worlds[n], "no_sync")):
        torch.testing.assert_close(got["local"], _loss_and_grads(params, data[r][0])[1][0],
                                   atol=TRAIN_ATOL, rtol=0)
        torch.testing.assert_close(got["synced"], mean_w, atol=TRAIN_ATOL, rtol=0)
    first = _all(worlds[n], "no_sync")[0]["params"]
    for got in _all(worlds[n], "no_sync"):
        assert all(torch.equal(a, b) for a, b in zip(got["params"], first))  # bit for bit


@pytest.mark.parametrize("n", SIZES)
def test_triggers_reduce_across_ranks(worlds, n):
    assert _all(worlds[n], "trigger") == [[False, True, False]] * n


def _joined_run(n, steps_of, lr=0.1):
    """SGD where rank r steps ``steps_of(r)`` times; a joined rank adds zeros
    and the sum is divided by the world, as DistributedDataParallel's join."""
    params, data = _linear_params(), _batches(n)
    losses = [[] for _ in range(n)]
    for t in range(max(steps_of(r) for r in range(n))):
        active = [r for r in range(n) if t < steps_of(r)]
        outs = {r: _loss_and_grads(params, data[r][t]) for r in active}
        mean_loss = sum(outs[r][0] for r in active) / len(active)
        for r in active:
            losses[r].append(mean_loss)
        grads = [sum(outs[r][1][i] for r in active) / n for i in range(2)]
        params = [p - lr * g for p, g in zip(params, grads)]
    return losses, params


@pytest.mark.parametrize("n", SIZES)
def test_join_uneven_inputs(worlds, n):
    losses, params = _joined_run(n, lambda r: 2 + r)
    for r, got in enumerate(_all(worlds[n], "join_uneven_inputs")):
        np.testing.assert_allclose(got["losses"], losses[r], atol=TRAIN_ATOL, rtol=0)
        for a, b in zip(got["params"], params):
            torch.testing.assert_close(a, b, atol=TRAIN_ATOL, rtol=0)
    _, imperative = _joined_run(n, lambda r: 1 + r)
    ranks = _all(worlds[n], "join_uneven_inputs_imperative")
    for got in ranks:
        assert all(torch.equal(a, b) for a, b in zip(got, ranks[0]))
        for a, b in zip(got, imperative):
            torch.testing.assert_close(a, b, atol=TRAIN_ATOL, rtol=0)


@pytest.mark.parametrize("n", SIZES)
def test_save_and_load_state_resume_the_unbroken_run(worlds, n):
    for r, got in enumerate(_all(worlds[n], "save_load_state")):
        assert got["resumed"] == got["unbroken"]
        assert got["params_equal"] and got["rng_equal"]
        assert [f"random_states_{i}.pkl" for i in range(n)] == \
            [f for f in got["files"] if f.startswith("random_states")]
        assert "rng_state.pkl" not in got["files"] and "_COMPLETE" in got["files"]
        assert "model_0.safetensors" in got["files"]


@pytest.mark.parametrize("n", SIZES)
def test_fp16_overflow_on_one_rank_skips_the_update_on_every_rank(worlds, n):
    for got in _all(worlds[n], "fp16_skip"):
        (skipped, scale), (skipped_loop, scale_loop) = got["make_train_step"], got["imperative"]
        assert skipped and skipped_loop and got["unchanged"]
        assert scale == 2.0 ** 15 * 0.5 and scale_loop == scale * 0.5  # backed off twice


@pytest.mark.parametrize("n", SIZES)
def test_trackers_and_save_write_from_the_main_process(worlds, n):
    got = _all(worlds[n], "main_process_writes")
    assert got[0]["trackers"] == ["jsonl"] and all(g["trackers"] == [] for g in got[1:])
    assert got[-1]["saved"] == ["saved_by_0.pt"]
