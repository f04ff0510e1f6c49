"""The port's data-parallel training step at 2 and 4 gloo ranks on the CPU
against the reference's step on a ``data = n`` mesh of host devices.

The reference's tiny GPT-2 (fp32, plain attention) weights go to the port
by `params_from_jax`; each rank of a world (`tests/torch_world.py`, running
`tests/torch_ddp_worker.py`) takes its slice of the same global batches (8
x 32) and runs 3 AdamW updates of ``make_train_step(lm_loss_fn)``: plainly,
with 2 microbatches an update (2 ranks), and through the ``bf16``, ``fp16``
and ``power_sgd`` comm hooks (rank 1, the first update plain). The reference
runs `accelerate_tpu`'s ``make_train_step`` on
``build_mesh(ParallelismConfig(data_parallel_size=n), devices[:n])`` with
the same hooks, and PowerSGD's initial Q of the reference
(``init_comm_state``) is carried to the port by parameter name. Every loss
and every parameter agree within the bars below, and every rank's
parameters equal rank 0's bit for bit. At 2 ranks the imperative loop
equals ``make_train_step`` bit for bit. Local SGD on the by_feature MLP
(Adam, a sync every 2 steps and at the end) agrees with the reference's
``make_local_train_step``. PowerSGD with its factors carried in bf16
(``comm_wrapper``) stays within the low-precision bars of the fp32 factors.

The worlds run while this process computes the reference.
"""

import importlib.util

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.local_sgd import LocalSGD as JaxLocalSGD  # noqa: E402
from accelerate_tpu.local_sgd import make_local_train_step as jax_make_local_train_step  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.models.gpt2 import lm_loss_fn as jax_lm_loss_fn  # noqa: E402
from accelerate_tpu.parallel.compression import CommHookConfig as JaxCommHookConfig  # noqa: E402
from accelerate_tpu.parallel.compression import init_comm_state as jax_init_comm_state  # noqa: E402
from accelerate_tpu.parallel.mesh import ParallelismConfig, build_mesh  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.examples.by_feature import _common  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import params_from_jax  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401
from torch_world import ROOT, World, result  # noqa: E402

SIZES = (2, 4)
HOOKS = ("plain", "bf16", "fp16", "power_sgd")
LR = 1e-2
MLP_SEED = 42
# fp32 on both sides, the gradient mean summed in another order: the bars
# of tests/test_torch_train.py (3 AdamW steps at lr 1e-2; m / sqrt(v)
# amplifies differences where a gradient is tiny)
LOSS_ATOL = 1e-5
PARAM_ATOL = 5e-4
# the bf16 and fp16 hooks round each rank's gradient and every partial sum
# to 8 or 11 bits, and XLA's and gloo's sums of 4 ranks add in other
# orders: where the ranks' gradients nearly cancel, the rounded means differ
# by units in the last place and now and then in sign, and Adam moves such
# an element by about lr either way. So: the loss within 1e-3, 99% of the
# elements within 1e-3, and every element within 2 lr a step (measured on
# the CPU at 4 ranks: bf16 1.7e-4 / 0.52% beyond 1e-3 / 0.0198 at most;
# fp16 3.3e-6 / 0.009% / 0.0098; at 2 ranks both meet the fp32 bars)
HOOK_LOSS_ATOL = 1e-3
HOOK_PARAM_ATOL = 1e-3
HOOK_PARAM_SHARE = 0.99


def _load_reference_common():
    spec = importlib.util.spec_from_file_location(
        "reference_by_feature_common", ROOT / "examples" / "by_feature" / "_common.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (8, 32)).astype(np.int32)


def _port_names(params):
    """Each reference leaf's position -> the port's parameter name, by
    passing markers through `params_from_jax` (a constant survives the
    kernels' transposes)."""
    leaves, treedef = jax.tree.flatten(params)
    markers = jax.tree.unflatten(treedef, [np.full(np.shape(x), i, np.float32)
                                           for i, x in enumerate(leaves)])
    return {int(t.reshape(-1)[0]): name for name, t in params_from_jax(markers).items()}, treedef


def _reference_step(jmod, params, batches, n, hook=None, k=1):
    for s in (AcceleratorState, GradientState, PartialState):
        s._reset_state()
    acc = JaxAccelerator(mixed_precision="no", gradient_accumulation_steps=k)
    acc.state.mesh = build_mesh(ParallelismConfig(data_parallel_size=n), devices=jax.devices()[:n])
    model, _ = acc.prepare((jmod, params), optax.adamw(LR))
    cfg = JaxCommHookConfig(hook, start_powerSGD_iter=1) if hook else None
    step = acc.make_train_step(jax_lm_loss_fn, comm_hook=cfg)
    losses = [float(step({"input_ids": jnp.asarray(b)})) for b in batches[:3 * k]]
    return {"losses": losses,
            "params": params_from_jax(jax.tree.map(np.asarray, model.params))}


def _reference_local_sgd(ref_common, batches, n):
    mesh = build_mesh(ParallelismConfig(data_parallel_size=n), devices=jax.devices()[:n])
    local_step, sync, replicate, unreplicate = jax_make_local_train_step(
        ref_common.loss_fn, ref_common.apply_fn, optax.adam(LR), mesh)
    island = replicate(ref_common.init_params(MLP_SEED))
    losses = []
    with JaxLocalSGD(sync_fn=sync, local_sgd_steps=2) as lsgd:
        for batch in batches:
            island, loss = local_step(island, {k: jnp.asarray(v) for k, v in batch.items()})
            island = lsgd.step(island)
            losses.append(np.asarray(loss))
    params = unreplicate(sync(island))
    return {"losses": np.stack(losses), "params": _common.params_from_jax(params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))
    batches = [_ids(10 + i) for i in range(6)]
    names, treedef = _port_names(params)
    rep, _ = jax_init_comm_state(params, JaxCommHookConfig("power_sgd", start_powerSGD_iter=1), 1)
    q = {names[i]: np.asarray(entry["q"]) for i, entry in enumerate(treedef.flatten_up_to(rep))
         if entry is not None}
    mlp_batches = _common.make_batches(4, 32, seed=3)
    inputs = tmp_path_factory.mktemp("inputs") / "inputs.pt"
    torch.save({"gpt2": params_from_jax(params), "batches": batches, "q": q,
                "mlp_seed": MLP_SEED, "mlp_batches": mlp_batches}, inputs)
    dirs = {n: tmp_path_factory.mktemp(f"world{n}") for n in SIZES}
    worlds = {n: World(ROOT / "tests" / "torch_ddp_worker.py", "run", (str(inputs), str(d)), n, d)
              for n, d in dirs.items()}
    ref_common = _load_reference_common()
    reference = {}
    for n in SIZES:
        for hook in HOOKS:
            reference[n, hook] = _reference_step(jmod, params, batches, n,
                                                 None if hook == "plain" else hook)
        reference[n, "local_sgd"] = _reference_local_sgd(ref_common, mlp_batches, n)
    reference[2, "plain_k2"] = _reference_step(jmod, params, batches, 2, k=2)
    return reference, {n: w.wait() for n, w in worlds.items()}


def _assert_params(got, want, atol):
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        a, b = p.numpy(), np.asarray(want[name])
        if name.endswith("attn.qkv.bias"):
            # the key third's gradient is zero in exact arithmetic (a constant
            # on every key logit leaves the softmax as it is): both sides move
            # it by Adam-scaled rounding noise, ~lr a step (test_torch_train)
            e = a.shape[0] // 3
            np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], atol=2 * LR * 3, rtol=0)
            a, b = np.delete(a, np.s_[e:2 * e]), np.delete(b, np.s_[e:2 * e])
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


def _assert_ranks_equal(world, case):
    first = result(world, 0, case)["params"]
    for r in range(1, len(world)):
        other = result(world, r, case)["params"]
        assert all(torch.equal(first[name], other[name]) for name in first), (case, r)


def _assert_params_within_rounding(got, want):
    """The low-precision hooks' bar (see HOOK_PARAM_SHARE)."""
    diffs = np.concatenate([np.abs(p.numpy() - np.asarray(want[name])).ravel()
                            for name, p in got.items()])
    assert diffs.max() <= 2 * LR * 3, diffs.max()
    assert np.mean(diffs <= HOOK_PARAM_ATOL) >= HOOK_PARAM_SHARE, np.mean(diffs <= HOOK_PARAM_ATOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("hook", HOOKS)
def test_data_parallel_step_matches_the_reference_mesh(runs, n, hook):
    reference, worlds = runs
    want = reference[n, hook]
    exact = hook in ("plain", "power_sgd")
    for r in range(n):
        got = result(worlds[n], r, hook)
        assert got["updates"] == 3
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=LOSS_ATOL if exact else HOOK_LOSS_ATOL)
        if exact:
            _assert_params(got["params"], want["params"], PARAM_ATOL)
        else:
            _assert_params_within_rounding(got["params"], want["params"])
    _assert_ranks_equal(worlds[n], hook)


def test_gradient_accumulation_across_ranks_matches_the_reference(runs):
    reference, worlds = runs
    want = reference[2, "plain_k2"]
    got = result(worlds[2], 0, "plain_k2")
    assert got["updates"] == 3
    np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_ATOL, rtol=0)
    _assert_params(got["params"], want["params"], PARAM_ATOL)
    _assert_ranks_equal(worlds[2], "plain_k2")


def test_power_sgd_factors_in_bf16_follow_the_fp32_factors(runs):
    """``comm_wrapper="bf16"`` (`CommHookConfig.wrapper`) carries P and Q in
    bf16: the run stays within the low-precision hooks' bars of the fp32
    factors' run, and the ranks stay equal."""
    _, worlds = runs
    got, want = (result(worlds[2], 0, c) for c in ("power_sgd_bf16_wrapper", "power_sgd"))
    assert got["updates"] == 3
    np.testing.assert_allclose(got["losses"], want["losses"], atol=HOOK_LOSS_ATOL, rtol=0)
    _assert_params_within_rounding(got["params"], want["params"])
    _assert_ranks_equal(worlds[2], "power_sgd_bf16_wrapper")


def test_power_sgd_moves_the_step_off_the_plain_one(runs):
    """The hook is in the path: after its first (plain) update, the
    compressed steps part from the plain run on both sides alike."""
    reference, worlds = runs
    for n in SIZES:
        plain, hooked = (result(worlds[n], 0, c)["params"] for c in ("plain", "power_sgd"))
        moved = max((plain[k] - hooked[k]).abs().max().item() for k in plain)
        assert moved > 10 * PARAM_ATOL, n


def test_imperative_loop_equals_make_train_step_bit_for_bit(runs):
    _, worlds = runs
    for r in range(2):
        step, loop = (result(worlds[2], r, c) for c in ("plain", "imperative"))
        assert loop["losses"] == step["losses"]
        assert all(torch.equal(loop["params"][k], step["params"][k]) for k in step["params"])


@pytest.mark.parametrize("n", SIZES)
def test_local_sgd_matches_the_reference(runs, n):
    reference, worlds = runs
    want = reference[n, "local_sgd"]
    for r in range(n):
        got = result(worlds[n], r, "local_sgd")
        np.testing.assert_allclose(got["losses"], want["losses"][:, r], atol=LOSS_ATOL, rtol=0)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(), atol=1e-5,
                                       rtol=0, err_msg=name)
    _assert_ranks_equal(worlds[n], "local_sgd")


def test_power_sgd_views_are_the_reference_kernels():
    """PowerSGD compresses the matrix the reference sees: an ``nn.Linear``
    weight ``[out, in]`` as flax's ``[in, out]`` kernel, a convolution's
    ``[out, in, kh, kw]`` as ``[kh, kw, in, out]`` with the output channels
    last, anything else as ``reshape(-1, last dim)``; `from_matrix` undoes
    each exactly."""
    from accelerate_tpu_torch.parallel.compression import as_matrix, from_matrix, matrix_views

    module = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Conv2d(3, 4, (2, 3)),
                                 torch.nn.Embedding(10, 6))
    views = matrix_views(module)
    assert views == {"0.weight": "linear", "1.weight": "conv"}
    g = torch.Generator().manual_seed(0)
    for name, p in module.named_parameters():
        if p.ndim < 2:
            continue
        t = torch.randn(p.shape, generator=g)
        kernel = t.T if name == "0.weight" else t.permute(2, 3, 1, 0) if name == "1.weight" else t
        m = as_matrix(t, views.get(name))
        assert torch.equal(m, kernel.reshape(-1, kernel.shape[-1])), name
        assert torch.equal(from_matrix(m, views.get(name), t.shape), t), name
