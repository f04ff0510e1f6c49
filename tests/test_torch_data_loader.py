"""The port's data pipeline (`accelerate_tpu_torch.data_loader`,
`utils.operations`) against the reference's, on the CPU: the accumulation
boundaries and ``end_of_dataloader`` sequence a prepared loader drives
through ``accumulate`` (a count that does not divide the epoch included),
``gather_for_metrics`` on a ragged tail, `BatchSamplerShard`'s indices,
resuming mid-epoch, the seeded sampler and the prefetch modes."""

import collections

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu import data_loader as jdl  # noqa: E402
from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu.utils import operations as jops  # noqa: E402
from accelerate_tpu_torch import data_loader as tdl  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.utils import operations as tops  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _jax_accelerator(**kwargs):
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    return JaxAccelerator(**kwargs)


def _batches(n, bs=8, seed=0):
    r = np.random.default_rng(seed)
    return [{"x": r.standard_normal((bs, 3)).astype(np.float32),
             "y": np.arange(i * bs, (i + 1) * bs, dtype=np.int64)} for i in range(n)]


def _walk(acc, dl, epochs=2):
    seen = []
    for _ in range(epochs):
        for batch in dl:
            with acc.accumulate():
                seen.append((acc.sync_gradients, acc.gradient_state.end_of_dataloader,
                             int(np.asarray(batch["y"])[0])))
    return seen


@pytest.mark.parametrize("k,n", [(1, 4), (2, 8), (3, 8), (4, 6)])
def test_boundaries_and_end_of_dataloader_match_reference(k, n):
    jacc = _jax_accelerator(gradient_accumulation_steps=k)
    want = _walk(jacc, jacc.prepare(jdl.DataLoaderShard(_batches(n))))
    acc = Accelerator(gradient_accumulation_steps=k, device="cpu")
    got = _walk(acc, acc.prepare(tdl.DataLoaderShard(_batches(n))))
    assert got == want
    # the epoch's last batch closes the window, and the count starts over
    syncs = [s for s, _, _ in got[:n]]
    assert syncs == [(i + 1) % k == 0 or i == n - 1 for i in range(n)]
    assert [e for _, e, _ in got[:n]] == [False] * (n - 1) + [True]
    assert got[:n] == got[n:]


def test_two_accelerators_do_not_share_boundaries():
    a = Accelerator(gradient_accumulation_steps=2, device="cpu")
    b = Accelerator(gradient_accumulation_steps=3, device="cpu")
    dl_a, dl_b = a.prepare(tdl.DataLoaderShard(_batches(2))), b.prepare(tdl.DataLoaderShard(_batches(5)))
    it_b = iter(dl_b)
    for batch in dl_a:  # a's last batch ends a's epoch only
        next(it_b)
        with a.accumulate(), b.accumulate():
            pass
    assert a.gradient_state.end_of_dataloader is False  # a's loader is done and popped
    assert b.gradient_state.end_of_dataloader is False and b.sync_gradients is False
    assert dl_a.gradient_state is a.gradient_state and dl_b.gradient_state is b.gradient_state


def test_gather_for_metrics_drops_the_ragged_tail():
    """20 samples in batches of 8: the last batch holds 4 real ones."""
    data = torch.utils.data.TensorDataset(torch.arange(20), torch.arange(20) * 2)
    jacc = _jax_accelerator()
    want = []
    for x, y in jacc.prepare(torch.utils.data.DataLoader(data, batch_size=8)):
        want.append(jacc.gather_for_metrics({"x": x, "y": y}))
    acc = Accelerator(device="cpu")
    dl = acc.prepare(torch.utils.data.DataLoader(data, batch_size=8))
    assert isinstance(dl, tdl.DataLoaderShard) and dl.remainder == 4
    got = [acc.gather_for_metrics({"x": x, "y": y}) for x, y in dl]
    assert [len(g["x"]) for g in got] == [len(np.asarray(w["x"])) for w in want] == [8, 8, 4]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))
        np.testing.assert_array_equal(g["y"].numpy(), np.asarray(w["y"]))
    # objects: no trim outside the last batch
    assert acc.gather_for_metrics(["a", "b"]) == ["a", "b"]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("even", [False, True])
@pytest.mark.parametrize("n,drop_last", [(23, False), (23, True), (32, False)])
def test_batch_sampler_shard_matches_reference(split, even, n, drop_last):
    base = torch.utils.data.BatchSampler(range(n), batch_size=4, drop_last=drop_last)
    for rank in range(2):
        want = jdl.BatchSamplerShard(base, 2, rank, split_batches=split, even_batches=even)
        got = tdl.BatchSamplerShard(base, 2, rank, split_batches=split, even_batches=even)
        assert list(got) == list(want)
        assert len(got) == len(want)
    assert list(tdl.BatchSamplerShard(base)) == list(jdl.BatchSamplerShard(base, 1, 0))
    assert list(tdl.BatchSamplerShard(base, even_batches=False)) == [list(b) for b in base]


def test_resume_mid_epoch_from_state_dict_and_skip_first_batches():
    acc = Accelerator(device="cpu")
    dl = acc.prepare(tdl.DataLoaderShard(_batches(6)))
    it = iter(dl)
    first = [int(next(it)["y"][0]) for _ in range(3)]
    state = dl.state_dict()
    assert state["batches_seen_in_epoch"] == 3 and not state["end_of_dataloader"]
    fresh = Accelerator(device="cpu").prepare(tdl.DataLoaderShard(_batches(6)))
    fresh.load_state_dict(state)
    assert first + [int(b["y"][0]) for b in fresh] == [8 * i for i in range(6)]
    # the skip applies to one pass only
    assert len(list(fresh)) == 6
    skipped = tdl.skip_first_batches(fresh, 4)
    assert skipped is fresh and [int(b["y"][0]) for b in skipped] == [32, 40]
    assert list(tdl.skip_first_batches([1, 2, 3], 1)) == [2, 3]
    sampler = tdl.SkipBatchSampler(torch.utils.data.BatchSampler(range(10), 3, False), 2)
    assert list(sampler) == [[6, 7, 8], [9]] and len(sampler) == 2


def test_seedable_sampler_reshuffles_each_epoch_and_resumes():
    data = torch.utils.data.TensorDataset(torch.arange(12))
    dl = tdl.prepare_data_loader(torch.utils.data.DataLoader(data, batch_size=4, shuffle=True),
                                 device="cpu", seed=7)
    assert isinstance(dl.synchronized_generator, tdl.SeedableRandomSampler)
    epoch0 = [b[0].tolist() for b in dl]
    epoch1 = [b[0].tolist() for b in dl]
    assert sorted(sum(epoch0, [])) == list(range(12)) and epoch0 != epoch1
    again = tdl.prepare_data_loader(torch.utils.data.DataLoader(data, batch_size=4, shuffle=True),
                                    device="cpu", seed=7)
    again.set_epoch(1)
    assert [b[0].tolist() for b in again] == epoch1


def test_prefetch_modes():
    batches = _batches(3)
    auto = [b["y"].tolist() for b in tdl.DataLoaderShard(batches, device="cpu", prefetch="auto")]
    assert auto == [b["y"].tolist() for b in tdl.DataLoaderShard(batches, device="cpu")]
    with pytest.raises(RuntimeError, match="ROADMAP Queue 1, item 31"):
        list(tdl.DataLoaderShard(batches, device="cpu", prefetch="native"))
    with pytest.raises(ValueError, match="none\\|auto\\|native"):
        tdl.DataLoaderShard(batches, prefetch="ring")


def test_unprepared_loader_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(tdl.DataLoaderShard(_batches(1)))


Pair = collections.namedtuple("Pair", "a b")


def test_operations_match_reference_at_one_process():
    r = np.random.default_rng(3)
    tree = {"z": r.standard_normal((3, 2)).astype(np.float32),
            "a": [r.standard_normal(4).astype(np.float16), 7],
            "p": Pair(np.arange(5), "s")}
    as_torch = tops.send_to_device(tree, "cpu")
    assert isinstance(as_torch["p"], Pair) and list(as_torch) == ["z", "a", "p"]
    assert tops.find_batch_size(as_torch) == jops.find_batch_size(tree) == 3
    assert tops.listify(as_torch) == jops.listify(tree)
    up = tops.convert_to_fp32(as_torch)
    assert up["a"][0].dtype == torch.float32 and up["p"].a.dtype == torch.int64
    arrays = {"z": tree["z"], "p": Pair(tree["p"].a, tree["z"])}
    cat = tops.concatenate([tops.send_to_device(arrays, "cpu")] * 2)
    want = jops.concatenate([arrays, arrays])
    assert isinstance(cat["p"], Pair)
    np.testing.assert_array_equal(cat["z"].numpy(), np.asarray(want["z"]))
    np.testing.assert_array_equal(cat["p"].a.numpy(), np.asarray(want["p"].a))
    assert tops.gather(as_torch) is as_torch and tops.gather_object([1, 2]) == [1, 2]
    assert torch.equal(tops.reduce(torch.ones(2), scale=3.0), torch.full((2,), 3.0))
    assert tops.pad_across_processes(as_torch) is as_torch
    assert tops.broadcast_object_list([4]) == [4]
    with pytest.raises(TypeError):
        tops.recursively_apply(lambda t: t, {"s": "x"}, error_on_other_type=True)
