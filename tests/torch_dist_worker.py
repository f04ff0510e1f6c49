"""The checks one rank of `tests/test_torch_distributed.py`'s worlds runs
(gloo on the CPU; see `tests/torch_world.py`). Each check records what the
test compares: the topology, the collectives' results, each loader's
indices, the gathered metrics, and the training loop's behaviour across
ranks. Imports nothing of JAX."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_world import Recorder  # noqa: E402


class Range(torch.utils.data.Dataset):
    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {"idx": torch.tensor(i), "x": torch.full((3,), float(i))}


class Stream(torch.utils.data.IterableDataset):
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield {"idx": torch.tensor(i), "x": torch.full((3,), float(i))}


def _ids(loader) -> list[list[int]]:
    return [b["idx"].tolist() for b in loader]


# inputs split by rank as arrays, tensors and lists: ragged, even, and
# shorter than the world (the last ranks' slices are empty)
SPLIT_ARRAYS = {"f6": [float(x) for x in range(6)], "i7": list(range(7)), "i9": list(range(9)),
                "i2": list(range(2)), "rows5": [[x, -x] for x in range(5)]}

LOADER_CASES = [  # (dataset length, batch size, split_batches, even_batches, drop_last)
    (17, 4, False, True, False), (17, 4, False, False, False), (16, 4, False, True, False),
    (17, 4, True, True, False), (18, 4, True, False, False), (17, 4, False, True, True),
    (3, 4, False, True, False), (21, 8, True, True, False),
]


def run(out: str) -> None:
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import (
        DataLoaderDispatcher,
        DataLoaderShard,
        IterableDatasetShard,
        prepare_data_loader,
        skip_first_batches,
    )
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.random import set_seed, synchronize_rng_states

    state = PartialState()
    r, n = state.process_index, state.num_processes
    rec = Recorder(Path(out), r)
    check = rec.check

    # ------------------------------------------------------------ topology
    def topology():
        acc = Accelerator()
        return {"rank": r, "world": n, "local": state.local_process_index,
                "distributed_type": str(acc.distributed_type), "mesh": dict(acc.mesh.shape),
                "use_distributed": acc.use_distributed, "device": str(acc.device),
                "main": acc.is_main_process, "last": acc.is_last_process,
                "backend": state.backend, "num_devices": acc.num_devices}

    check("topology", topology)

    def barrier_orders():
        marker = Path(out) / "main_first.marker"
        state.wait_for_everyone()
        with state.main_process_first():
            if state.is_main_process:
                time.sleep(0.2)
                marker.write_text("main")
            seen = marker.exists()
        state.wait_for_everyone()
        return seen

    check("main_process_first", barrier_orders)

    def split():
        got = {}
        for pad in (False, True):
            with state.split_between_processes(list(range(7)), apply_padding=pad) as s:
                got[f"list_{pad}"] = list(s)
            with state.split_between_processes({"a": list(range(5)), "b": list("abcde")},
                                               apply_padding=pad) as s:
                got[f"dict_{pad}"] = s
            with state.split_between_processes(tuple(range(7)), apply_padding=pad) as s:
                got[f"tuple_{pad}"] = s
            for name, data in SPLIT_ARRAYS.items():
                with state.split_between_processes(np.asarray(data), apply_padding=pad) as s:
                    got[f"numpy_{name}_{pad}"] = s.tolist()
                with state.split_between_processes(torch.as_tensor(data), apply_padding=pad) as s:
                    got[f"tensor_{name}_{pad}"] = s.tolist()
                with state.split_between_processes(list(data), apply_padding=pad) as s:
                    got[f"list_{name}_{pad}"] = list(s)
        return got

    check("split_between_processes", split)

    # --------------------------------------------------------- collectives
    check("gather_equal", lambda: ops.gather(torch.full((2, 3), float(r))).tolist())
    check("gather_ragged", lambda: ops.gather(torch.arange(r + 1, dtype=torch.float32)).tolist())
    check("gather_scalar", lambda: ops.gather(torch.tensor(float(r) * 2)).tolist())
    check("gather_numpy_nested", lambda: (lambda g: {"a": g["a"].tolist(), "t": type(g["a"]).__name__,
                                                     "b": g["b"][0].tolist()})(
        ops.gather({"a": np.arange(r, r + 2), "b": [torch.full((1,), r)]})))
    check("gather_object", lambda: ops.gather_object([f"proc{r}", {"r": r}]))
    check("broadcast_last", lambda: ops.broadcast(torch.full((3,), float(r + 5)),
                                                  from_process=n - 1).tolist())
    check("broadcast_nested_numpy", lambda: (lambda b: [b["x"].tolist(), type(b["x"]).__name__])(
        ops.broadcast({"x": np.full((2,), r, dtype=np.int64)}, from_process=1)))

    def broadcast_keeps_input():
        t = torch.full((2,), float(r))
        ops.broadcast(t, from_process=0)
        return t.tolist()

    check("broadcast_keeps_input", broadcast_keeps_input)
    check("broadcast_object_list_last",
          lambda: ops.broadcast_object_list([f"payload{r}", r * 10], from_process=n - 1))
    check("pad_dim0", lambda: ops.pad_across_processes(np.arange(float(r + 1))).tolist())
    check("pad_dim1_first", lambda: ops.pad_across_processes(
        torch.ones(2, r + 1), dim=1, pad_index=-1, pad_first=True).tolist())
    check("reduce_sum", lambda: ops.reduce(torch.tensor([1.0 + r, 2.0]), reduction="sum").tolist())
    check("reduce_mean_scale", lambda: ops.reduce(torch.tensor([1.0 + r]), reduction="mean",
                                                  scale=2.0).tolist())
    check("pad_input_tensors", lambda: ops.pad_input_tensors(torch.arange(5), 5, n).tolist())
    check("consolidate_on_main", lambda: (lambda c: None if c["w"] is None else c["w"].tolist())(
        ops.consolidate_on_main({"w": torch.ones(2)})))

    def verify_in_debug_mode():
        os.environ["ACCELERATE_TPU_DEBUG_MODE"] = "1"
        try:
            ops.gather(torch.zeros(r + 1, 2))  # ragged dim 0: allowed
            try:
                ops.reduce(torch.zeros(r + 1))
            except ops.DistributedOperationException as exc:
                return str(exc)
            return "no exception"
        finally:
            del os.environ["ACCELERATE_TPU_DEBUG_MODE"]

    check("verify_operation", verify_in_debug_mode)

    def rng():
        set_seed(7, device_specific=True)
        own = torch.rand(2).tolist()
        set_seed(100 + r)
        synchronize_rng_states()
        synced = (torch.rand(2).tolist(), float(np.random.rand()))
        return {"own": own, "synced": synced}

    check("rng", rng)

    def rng_types_epochs():
        import random

        set_seed(100 + r)  # each rank starts elsewhere
        dl = DataLoaderShard([np.zeros(2)] * 2, device="cpu", rng_types=["python", "numpy", "torch"])
        draws = []
        for _ in range(2):
            for i, _batch in enumerate(dl):
                if i == 0:
                    draws.append([random.random(), float(np.random.rand()), torch.rand(1).item()])
        return draws

    check("rng_types_epochs", rng_types_epochs)

    # ------------------------------------------------------------- loaders
    def loaders():
        got = {}
        for case in LOADER_CASES:
            size, bs, split_b, even, drop = case
            dl = torch.utils.data.DataLoader(Range(size), batch_size=bs, drop_last=drop)
            shard = prepare_data_loader(dl, device="cpu", split_batches=split_b,
                                        even_batches=even)
            got[case] = (_ids(shard), shard.remainder)
        return got

    check("batch_sampler_shard", loaders)

    def iterable_shard():
        got = {}
        for size, bs, split_b in ((17, 4, False), (16, 4, True), (5, 4, False)):
            dl = torch.utils.data.DataLoader(Stream(size), batch_size=bs)
            shard = prepare_data_loader(dl, device="cpu", split_batches=split_b,
                                        dispatch_batches=False)
            assert isinstance(shard.dataset, IterableDatasetShard)
            got[(size, bs, split_b)] = _ids(shard)
            direct = IterableDatasetShard(range(size), bs, n, r, split_batches=split_b)
            got[("direct", size, bs, split_b)] = list(direct)
        return got

    check("iterable_dataset_shard", iterable_shard)

    def dispatcher():
        dl = torch.utils.data.DataLoader(Stream(19), batch_size=6)
        shard = prepare_data_loader(dl, device="cpu")
        assert isinstance(shard, DataLoaderDispatcher)
        seen = []
        for batch in shard:
            seen.append((batch["idx"].tolist(), shard.end_of_dataloader))
        return {"batches": seen, "remainder": shard.remainder}

    check("dispatcher", dispatcher)

    def global_batches():
        batches = [{"idx": np.arange(i * 6, i * 6 + 6)} for i in range(3)]
        batches.append({"idx": np.arange(18, 23)})  # a last batch of 5
        dl = DataLoaderShard(batches, device="cpu", num_processes=n, process_index=r)
        first = _ids(dl)
        skipped = _ids(skip_first_batches(dl, 2))
        return {"slices": first, "remainder": dl.remainder, "skipped": skipped}

    check("global_batch_slices", global_batches)

    def metrics():
        acc = Accelerator()
        batches = [{"x": np.arange(i * 8, i * 8 + 8, dtype=np.float32)} for i in range(4)]
        batches.append({"x": np.arange(32, 37, dtype=np.float32)})  # 37 samples in all
        eval_dl = acc.prepare(DataLoaderShard(batches))
        gathered = [acc.gather_for_metrics(b["x"]).tolist() for b in eval_dl]
        torch_dl = acc.prepare(torch.utils.data.DataLoader(Range(37), batch_size=4))
        gathered_torch = [acc.gather_for_metrics(b["idx"]).tolist() for b in torch_dl]
        objects = []
        for b in acc.prepare(DataLoaderShard(batches)):
            objects += acc.gather_for_metrics([int(v) for v in b["x"].tolist()],
                                              use_gather_object=True)
        return {"plain": gathered, "torch": gathered_torch, "objects": objects}

    check("gather_for_metrics", metrics)

    # ------------------------------------------------------ training loop
    def linear(seed: int = 0):
        torch.manual_seed(seed + r)  # ranks differ; prepare broadcasts rank 0's
        return torch.nn.Linear(4, 3)

    def mse(model, batch):
        return ((model(batch["x"]) - batch["y"]) ** 2).mean()

    data = torch.Generator().manual_seed(3)
    xs = torch.randn(6, n * 2, 4, generator=data)
    ys = torch.randn(6, n * 2, 3, generator=data)
    mine = [{"x": xs[i, r * 2:(r + 1) * 2], "y": ys[i, r * 2:(r + 1) * 2]} for i in range(6)]

    def prepared_equal():
        acc = Accelerator()
        model = acc.prepare(linear())
        return [p.detach().clone() for p in model.module.parameters()]

    check("prepare_broadcasts_rank0", prepared_equal)

    def no_sync():
        acc = Accelerator()
        model = linear()
        model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
        with acc.no_sync(model):
            acc.backward(mse, mine[0])
            local = model.module.weight.grad.clone()
        acc.backward(mse, mine[1])  # a sync backward: averages the sum of both
        synced = model.module.weight.grad.clone()
        opt.step()
        return {"local": local, "synced": synced,
                "params": [p.detach().clone() for p in model.module.parameters()]}

    check("no_sync", no_sync)

    def trigger():
        acc = Accelerator()
        before = acc.check_trigger()
        if r == n - 1:
            acc.set_trigger()
        return [before, acc.check_trigger(), acc.check_trigger()]

    check("trigger", trigger)

    def join():
        acc = Accelerator()
        model = linear()
        model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
        step = acc.make_train_step(mse)
        losses = []
        with acc.join_uneven_inputs([model]):
            for batch in mine[:2 + r]:  # rank r has 2 + r batches
                losses.append(step(batch).item())
        return {"losses": losses, "params": [p.detach().clone() for p in model.module.parameters()]}

    check("join_uneven_inputs", join)

    def imperative_join():
        acc = Accelerator()
        model = linear()
        model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
        with acc.join_uneven_inputs([model]):
            for batch in mine[:1 + r]:
                acc.backward(mse, batch)
                opt.step()
                opt.zero_grad()
        return [p.detach().clone() for p in model.module.parameters()]

    check("join_uneven_inputs_imperative", imperative_join)

    def checkpoint():
        from accelerate_tpu_torch.accelerator import ProjectConfiguration

        def fresh():
            acc = Accelerator(project_config=ProjectConfiguration(project_dir=out))
            model = linear()
            model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.05))
            return acc, model, acc.make_train_step(mse)

        acc, model, step = fresh()
        for b in mine[:2]:
            step(b)
        set_seed(1000 + r)  # each rank's own RNG state, restored by load_state
        where = acc.save_state(str(Path(out) / "ckpt"))
        want_rng = torch.rand(3).tolist()
        unbroken = [step(b).item() for b in mine[2:4]]
        acc2, model2, step2 = fresh()
        torch.manual_seed(0)
        acc2.load_state(where)
        got_rng = torch.rand(3).tolist()
        resumed = [step2(b).item() for b in mine[2:4]]
        files = sorted(p.name for p in Path(where).iterdir())
        return {"unbroken": unbroken, "resumed": resumed, "files": files,
                "rng_equal": got_rng == want_rng,
                "params_equal": all(torch.equal(a, b) for a, b in
                                    zip(model.module.parameters(), model2.module.parameters()))}

    check("save_load_state", checkpoint)

    def fp16_skip():
        # rank n-1's batch overflows: every rank skips the update, the scale
        # backs off on every rank, and the parameters stay rank 0's
        acc = Accelerator(mixed_precision="fp16")
        model = linear()
        model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
        before = [p.detach().clone() for p in model.module.parameters()]
        batch = dict(mine[0])
        if r == n - 1:
            batch = {"x": torch.full_like(batch["x"], 1e30), "y": batch["y"]}
        def mse16(model, batch):  # the module computes in fp16
            return ((model(batch["x"].half()).float() - batch["y"]) ** 2).mean()

        step = acc.make_train_step(mse16)
        step(batch)
        skipped_step = (opt.step_was_skipped, float(opt.scaler_state.scale))
        acc.backward(mse16, batch)  # the imperative loop: the vote in optimizer.step()
        opt.step()
        return {"make_train_step": skipped_step,
                "imperative": (opt.step_was_skipped, float(opt.scaler_state.scale)),
                "unchanged": all(torch.equal(a, b) for a, b in
                                 zip(before, model.module.parameters()))}

    check("fp16_skip", fp16_skip)

    def main_process_writes():
        acc = Accelerator(log_with="jsonl", project_dir=str(Path(out) / "tracked"))
        acc.init_trackers("dp")
        acc.log({"rank": r})
        acc.save({"rank": r}, str(Path(out) / f"saved_by_{r}.pt"))
        acc.end_training()
        return {"trackers": [t.name for t in acc.trackers],
                "saved": sorted(p.name for p in Path(out).glob("saved_by_*.pt"))}

    check("main_process_writes", main_process_writes)

    state.wait_for_everyone()
    rec.save()
    state.shutdown()
