"""The install check that ``python -m accelerate_tpu_torch.commands.cli test``
runs: the port of `accelerate_tpu.test_utils.test_script`, over the port's
modules, on whatever topology the launcher gave it (one process, or one a
device).

Its checks are the reference's inventory: rank-gated execution and RNG
synchronization, the collectives, shard and dispatcher loader preparation
across the ``split_batches`` x ``even_batches`` x ``drop_last`` matrix, the
seedable sampler's epochs, data-parallel training against the weights of
one process over the same global batches, bf16 training, a mid-epoch
checkpoint resume, ``split_between_processes``, the trigger, and a new
accelerator after an old one. At two processes it chains the ported
multi-process scripts (`test_utils.scripts`): collective ops, gradient
accumulation, the dispatcher loop and ``gather_for_metrics``.

``main(device)``: ``None`` is the launcher's device (CUDA, or the CPU under
``--debug_cpu``); two ranks sharing one card over gloo pass ``"cuda:0"``.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0  # prepare_data_loader's default sampler seed


def _state(device):
    from ..state import PartialState

    return PartialState(device)


def _accelerator(device, **kwargs):
    from ..accelerator import Accelerator

    return Accelerator(device=device, **kwargs)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------- rank-gated execution
def check_process_execution(device=None) -> None:
    """The main, local-main and last-process gates fire on exactly their
    ranks, checked across processes (reference `test_script.py:28`)."""
    from ..utils import operations

    state = _state(device)
    fired: list[str] = []

    @state.on_main_process
    def a() -> None:
        fired.append("main")

    @state.on_local_main_process
    def b() -> None:
        fired.append("local_main")

    @state.on_process(process_index=state.num_processes - 1)
    def c() -> None:
        fired.append("last")

    a(), b(), c()
    everywhere = operations.gather_object([sorted(fired)])
    expect_main = ["local_main", "main"] if state.num_processes > 1 else ["last", "local_main", "main"]
    assert everywhere[0] == sorted(expect_main), everywhere
    if state.num_processes > 1:
        assert "last" in everywhere[-1], everywhere
    with state.main_process_first():
        pass
    print("  rank-gated execution: OK")


def check_rng_sync(device=None) -> None:
    from ..utils import operations
    from ..utils.random import set_seed, synchronize_rng_states

    set_seed(1234, device_specific=True)  # each rank starts elsewhere
    synchronize_rng_states()
    sample = np.random.normal(size=(4,)).tolist() + torch.rand(2).tolist()
    gathered = operations.gather_object([sample])
    assert all(g == gathered[0] for g in gathered), "RNG out of sync across processes"
    set_seed(1234)
    assert np.random.normal(size=(4,)).tolist() + torch.rand(2).tolist() == gathered[0], \
        "set_seed not reproducible"
    print("  RNG synchronization: OK")


# ----------------------------------------------------------- loader preparation
def _regression_loader(n: int, batch_size: int, drop_last: bool, shuffle: bool):
    import torch.utils.data as tud

    class DS(tud.Dataset):
        def __len__(self) -> int:
            return n

        def __getitem__(self, i: int):
            return {"x": torch.tensor([float(i)]), "idx": torch.tensor(i)}

    return tud.DataLoader(DS(), batch_size=batch_size, shuffle=shuffle, drop_last=drop_last)


def check_dl_preparation(device=None) -> None:
    """Shard-mode loaders across ``split_batches`` x ``even_batches`` x
    ``drop_last`` give back the dataset in order, with padding only after
    the real data and the reference's drops (reference
    `test_script.py:80`)."""
    from ..data_loader import BatchSamplerShard, prepare_data_loader
    from ..utils import operations

    state = _state(device)
    P = state.num_processes
    gbs = 4 * P
    bs = gbs // P
    n = 2 * gbs + max(gbs // 2, 1) + 1
    for split_batches in (False, True):
        for drop_last in (False, True):
            for even_batches in (True,) if P > 1 else (True, False):
                loader = _regression_loader(n, gbs if split_batches else bs, drop_last, False)
                dl = prepare_data_loader(loader, device=state.device, split_batches=split_batches,
                                         even_batches=even_batches, use_seedable_sampler=False)
                got = np.concatenate([_host(operations.gather(b["idx"])) for b in dl])
                tag = f"sb={split_batches} dl={drop_last} eb={even_batches}"
                if drop_last:
                    kept = (n // gbs) * gbs if split_batches else ((n // bs) // P) * gbs
                    np.testing.assert_array_equal(got, np.arange(kept), err_msg=tag)
                else:
                    np.testing.assert_array_equal(got[:n], np.arange(n), err_msg=tag)
                    assert len(got) % gbs == 0 or P == 1, (tag, len(got))
                assert dl.remainder in (-1, n % gbs), (tag, dl.remainder)

    # even_batches=False at a simulated 4 processes, on the sampler shard itself
    class _BS:
        batch_size, drop_last = 4, False

        def __iter__(self):
            yield from ([list(range(i, min(i + 4, 22))) for i in range(0, 22, 4)])

        def __len__(self):
            return 6

    for drop_last in (False, True):
        _BS.drop_last = drop_last
        per_proc = [list(BatchSamplerShard(_BS(), 4, p, split_batches=False, even_batches=False))
                    for p in range(4)]
        flat = [i for proc in per_proc for b in proc for i in b]
        if drop_last:
            assert sorted(flat) == list(range(16)), flat
            assert [len(p) for p in per_proc] == [1, 1, 1, 1], per_proc
        else:
            assert sorted(flat) == list(range(22)), flat
            assert [len(p) for p in per_proc] == [2, 2, 1, 1], per_proc
    print("  shard dataloader preparation (split x even x drop matrix): OK")


def check_central_dl_preparation(device=None) -> None:
    """Dispatcher mode (rank 0 reads, every rank slices) and
    ``gather_for_metrics`` give back exactly the dataset despite the ragged
    last batch (reference `test_script.py:165`)."""
    from ..data_loader import DataLoaderDispatcher

    state = _state(device)
    data = np.arange(27.0)
    batches = [data[i:i + 8] for i in range(0, 27, 8)]
    acc = _accelerator(device)
    dl = acc.prepare(DataLoaderDispatcher(batches if state.is_main_process else []))
    seen = [_host(acc.gather_for_metrics(b)) for b in dl]
    np.testing.assert_array_equal(np.concatenate(seen), data)
    print("  dispatcher dataloader + remainder-exact metrics: OK")


def check_seedable_sampler(device=None) -> None:
    """The same permutation on every process, a new one each epoch, and the
    same again from the seed (reference `test_script.py:186`)."""
    from ..data_loader import SeedableRandomSampler, prepare_data_loader
    from ..utils import operations

    s = SeedableRandomSampler(16, seed=7)
    e0, e1 = list(s), list(s)
    assert e0 != e1, "epochs must reshuffle"
    assert list(SeedableRandomSampler(16, seed=7)) == e0, "same seed+epoch must reproduce"
    state = _state(device)
    P = state.num_processes
    gbs = 4 * P
    n = 4 * gbs
    loader = _regression_loader(n, gbs // P, drop_last=False, shuffle=True)
    dl = prepare_data_loader(loader, device=state.device, use_seedable_sampler=True)
    order = np.concatenate([_host(operations.gather(b["idx"])) for b in dl]).tolist()
    gathered = operations.gather_object([order])
    assert all(g == gathered[0] for g in gathered), "sampler out of sync"
    assert sorted(order) == list(range(n))
    print("  seedable sampler epoch evolution + cross-process sync: OK")


# ------------------------------------------------------------- training parity
def _global_batch_stream(n: int, gbs: int, epochs: int, seed: int = SEED):
    """The global batches a prepared seedable-sampler loader yields: each
    epoch's permutation from ``seed + epoch``, cut by the global batch."""
    for e in range(epochs):
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed + e)).numpy()
        for g in range(n // gbs):
            yield perm[g * gbs:(g + 1) * gbs]


def check_training_parity_matrix(device=None) -> None:
    """Training through the accelerator (sharded loader, prepared optimizer,
    the imperative loop) lands on the weights of one process over the same
    global batches, for ``split_batches`` False and True over two epochs
    (reference `test_script.py:229`)."""
    import torch.utils.data as tud

    from .training import RegressionModel

    state = _state(device)
    P = state.num_processes
    gbs = 4 * P
    bs, epochs, lr = gbs // P, 2, 0.1
    n = 4 * gbs
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(n, 1)).astype(np.float32)
    ys = (3.0 * xs + 1.5).astype(np.float32)

    class DS(tud.Dataset):
        def __len__(self) -> int:
            return n

        def __getitem__(self, i: int):
            return {"x": torch.from_numpy(xs[i]), "y": torch.from_numpy(ys[i])}

    def loss_fn(model, batch):
        return ((model(batch["x"]) - batch["y"]) ** 2).mean()

    for split_batches in (False, True):
        a = b = np.zeros((1,), np.float64)
        for idx in _global_batch_stream(n, gbs, epochs):
            err = a * xs[idx] + b - ys[idx]
            a, b = a - lr * (2 * err * xs[idx]).mean(), b - lr * (2 * err).mean()

        acc = _accelerator(device, split_batches=split_batches)
        module = RegressionModel(device=acc.device)
        loader = tud.DataLoader(DS(), batch_size=gbs if split_batches else bs, shuffle=True)
        model, opt, dl = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=lr), loader)
        for _ in range(epochs):
            for batch in dl:
                with acc.accumulate(model):
                    acc.backward(loss_fn, batch)
                    opt.step()
                    opt.zero_grad()
        got = acc.get_state_dict(model)
        for k, want in (("a", a), ("b", b)):
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"split_batches={split_batches} param {k}")
    print("  distributed == single-process weights (split_batches x epochs): OK")


def check_bf16_training(device=None) -> None:
    """bf16 trains to a finite, falling loss with fp32 masters (reference
    `test_script.py:307`)."""
    from ..data_loader import DataLoaderShard
    from .training import RegressionModel, make_regression_batches, regression_loss_fn

    acc = _accelerator(device, mixed_precision="bf16")
    module = RegressionModel(device=acc.device)
    model, _, dl = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.05),
                               DataLoaderShard(make_regression_batches(8, 16)))
    step = acc.make_train_step(regression_loss_fn)
    losses = [float(step(b)) for b in dl]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in module.parameters())
    print("  bf16 mixed-precision training: OK")


def check_mid_epoch_resume(device=None) -> None:
    """Save at a mid-epoch boundary, load into new objects, finish the epoch
    from the skipped loader: the same weights as the run without a break
    (reference `test_script.py:336`)."""
    import shutil
    import tempfile

    from ..data_loader import DataLoaderShard, skip_first_batches
    from ..utils.operations import broadcast_object_list
    from .training import RegressionModel, make_regression_batches, regression_loss_fn

    batches = make_regression_batches(6, 8)

    def fresh():
        acc = _accelerator(device)
        module = RegressionModel(device=acc.device)
        model, opt = acc.prepare(module, torch.optim.Adam(module.parameters(), lr=0.05))
        return acc, model, opt

    def run(acc, model, opt, dl, stop=None):
        for i, b in enumerate(dl):
            if i == stop:
                break
            with acc.accumulate(model):
                acc.backward(regression_loss_fn, b)
                opt.step()
                opt.zero_grad()

    acc, model, opt = fresh()
    run(acc, model, opt, acc.prepare(DataLoaderShard(batches)))
    want = acc.get_state_dict(model)

    state = _state(device)
    payload = broadcast_object_list([tempfile.mkdtemp() if state.is_main_process else None])
    td = payload[0]
    try:
        acc, model, opt = fresh()
        run(acc, model, opt, acc.prepare(DataLoaderShard(batches)), stop=3)
        ckpt = acc.save_state(td + "/ck")
        acc2, model2, opt2 = fresh()
        acc2.load_state(ckpt)
        run(acc2, model2, opt2, skip_first_batches(acc2.prepare(DataLoaderShard(batches)), 3))
        got = acc2.get_state_dict(model2)
    finally:
        state.wait_for_everyone()
        if state.is_main_process:
            shutil.rmtree(td, ignore_errors=True)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6)
    print("  mid-epoch checkpoint resume: OK")


# ------------------------------------------------------------------- utilities
def check_split_between_processes(device=None) -> None:
    """Lists, dicts, arrays and tensors, padded or not (reference
    `test_script.py:406`)."""
    from ..utils import operations

    state = _state(device)
    P = state.num_processes
    with state.split_between_processes(list(range(10))) as piece:
        all_pieces = operations.gather_object([list(piece)])
    assert sorted(x for p in all_pieces for x in p) == list(range(10)), all_pieces
    with state.split_between_processes({"a": list(range(8)), "b": np.arange(8.0)}) as piece:
        assert len(piece["a"]) == len(piece["b"])
    with state.split_between_processes(np.arange(12.0).reshape(6, 2)) as piece:
        assert piece.shape[1] == 2
    with state.split_between_processes(torch.arange(12.0).reshape(6, 2)) as piece:
        assert piece.shape[1] == 2
    for data in (list(range(P * 2 + 1)), np.arange(P * 2 + 1), torch.arange(P * 2 + 1)):
        with state.split_between_processes(data, apply_padding=True) as piece:
            lengths = operations.gather_object([len(piece)])
        assert len(set(lengths)) == 1, lengths
    print("  split_between_processes (list/dict/tensor/padded): OK")


def check_trigger(device=None) -> None:
    acc = _accelerator(device)
    acc.set_trigger()
    assert acc.check_trigger()
    assert not acc.check_trigger()  # a read lowers the flag
    print("  early-stop trigger: OK")


def check_reinstantiated_state(device=None) -> None:
    """A new accelerator after the others serves a working model (reference
    `test_script.py:438`)."""
    from .training import RegressionModel

    acc = _accelerator(device)
    assert acc.num_processes >= 1
    model = acc.prepare_model(RegressionModel(a=1.0, device=acc.device))
    out = model(torch.ones((2, 1), device=acc.device))
    np.testing.assert_allclose(_host(out), np.ones((2, 1)))
    print("  reinstantiated state: OK")


def check_collectives(device=None) -> None:
    from ..utils import operations

    x = np.arange(8.0)
    out = np.asarray(operations.gather(x))
    assert out.size % 8 == 0, out.shape
    np.testing.assert_array_equal(out.reshape(-1, 8), np.tile(x, (out.size // 8, 1)))
    red = operations.reduce(torch.ones((4,), device=_state(device).device), "sum")
    assert tuple(red.shape) == (4,) and _host(red).tolist() == [_state(device).num_processes] * 4
    objs = operations.gather_object(["ping"])
    assert objs.count("ping") == len(objs)
    print("  collectives: OK")


# the chained scripts at two processes (the reference's others wait: ROADMAP item 41)
CHAINED = ("test_multiprocess_ops", "test_sync", "test_dispatcher", "test_metrics")


CHECKS = (check_rng_sync, check_process_execution, check_collectives, check_dl_preparation,
          check_central_dl_preparation, check_seedable_sampler, check_split_between_processes,
          check_training_parity_matrix, check_bf16_training, check_mid_epoch_resume, check_trigger,
          check_reinstantiated_state)


def main(device: str | torch.device | None = None) -> None:
    import importlib

    state = _state(device)
    print(f"Running accelerate_tpu_torch sanity suite on {state.device}, "
          f"{state.num_processes} process(es)")
    for check in CHECKS:
        check(device)
    if state.num_processes == 2:
        for name in CHAINED:
            importlib.import_module(f".scripts.{name}", __package__).run_checks(device=device)
            print(f"  launched-script chain [{name}]: OK")
    state.wait_for_everyone()


if __name__ == "__main__":
    main()
