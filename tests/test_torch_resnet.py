"""The port's ResNet (`accelerate_tpu_torch.models.resnet`) against the
reference's flax ResNet, on the CPU, in fp32.

Two configs, the reference's ``tiny()`` (basic blocks) and a small
bottleneck one, each at an even and an odd image size (32 and 33: XLA's
``"SAME"`` padding is asymmetric for a stride-2 convolution or pool on an
even size and symmetric on an odd one). From the same weights
(`params_from_jax`) the logits agree within 1e-4, and the loss and every
parameter's gradient within the tolerances below. Three SGD-momentum
``make_train_step`` steps agree with the reference's, the param tree
survives `params_to_jax`, and under the bf16 policy GroupNorm and the
classifier compute in fp32 as the reference's do."""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from accelerate_tpu.models.resnet import ResNetConfig as JaxResNetConfig  # noqa: E402
from accelerate_tpu.models.resnet import image_classification_loss_fn as jax_loss_fn  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.models.resnet import (  # noqa: E402
    ResNet,
    ResNetConfig,
    image_classification_loss_fn,
    params_from_jax,
    params_to_jax,
    same_pads,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
# fp32 both sides, one summation order apart: the largest gradient error
# read was 1.5e-7 against gradients of 0.02-0.08
GRAD_ATOL = 1e-5
# three SGD steps at lr 0.1 with momentum carry those differences on
STEP_ATOL = 1e-5

BOTTLENECK = dict(stage_sizes=(1, 1), bottleneck=True, num_filters=8, num_groups=4,
                  num_classes=10)
CONFIGS = {
    "tiny": (lambda: JaxResNetConfig.tiny(dtype=jnp.float32),
             lambda: ResNetConfig.tiny(dtype=torch.float32)),
    "bottleneck": (lambda: JaxResNetConfig(**BOTTLENECK, dtype=jnp.float32),
                   lambda: ResNetConfig(**BOTTLENECK, dtype=torch.float32)),
}


def _batch(size, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _pair(name, size, seed=0):
    jcfg, pcfg = CONFIGS[name]
    jmod = JaxResNet(jcfg())
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(seed), image_size=size))
    model = ResNet(pcfg(), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jmod, params, model


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_same_padding_is_xla_s():
    assert same_pads(224, 7, 2) == (2, 3)  # the stem: not nn.Conv2d(padding=3)
    assert same_pads(112, 3, 2) == (0, 1)  # the stem's max pool and a stage's first 3x3
    assert same_pads(33, 3, 2) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(56, 3, 1) == (1, 1)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("name", ["tiny", "bottleneck"])
def test_logits_loss_and_gradients_match_the_reference(name, size):
    jmod, params, model = _pair(name, size)
    batch = _batch(size)

    def loss(p):
        logits = jmod.apply({"params": p}, batch["image"])
        return jax_loss_fn(lambda _: logits, batch), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    logits = model(torch.from_numpy(batch["image"]))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=LOGIT_ATOL,
                               rtol=0)
    got = image_classification_loss_fn(model, _t(batch))
    assert abs(float(got.detach()) - float(jloss)) < LOSS_ATOL
    got.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=n)
    assert not list(model.buffers())  # GroupNorm: no running statistics


def test_three_sgd_momentum_steps_match_the_reference():
    jmod, params, model = _pair("bottleneck", 32, seed=3)
    batches = [_batch(32, seed=s) for s in (1, 2, 3)]
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    jacc = JaxAccelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((jmod, params), optax.sgd(0.1, momentum=0.9))
    jstep = jacc.make_train_step(jax_loss_fn)
    acc = Accelerator(device="cpu")
    pmodel = acc.prepare(model)
    acc.prepare(torch.optim.SGD(pmodel.parameters(), lr=0.1, momentum=0.9))
    step = acc.make_train_step(image_classification_loss_fn)
    for batch in batches:
        assert abs(float(step(_t(batch))) - float(jstep(batch))) < LOSS_ATOL
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=STEP_ATOL, rtol=0,
                                   err_msg=n)


def test_params_round_trip_and_shapes():
    jmod, params, model = _pair("bottleneck", 33)
    back = params_to_jax(model.state_dict())
    assert jax.tree.structure(jax.tree.map(lambda _: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, params))
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree.leaves(jax.tree.map(np.asarray, back))):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    assert model.conv_stem.weight.shape == (8, 3, 7, 7)  # OIHW from HWIO
    assert model.conv_stem.weight.is_contiguous(memory_format=torch.channels_last)
    assert model.classifier.weight.shape == (10, 64)  # [out, in] from [in, out]


def test_fresh_weights_follow_flax_initializers():
    model = ResNet(ResNetConfig.resnet18(num_filters=16, num_classes=10), device="cpu", seed=0)
    w = model.stage1_block0.conv2.weight.detach()  # fan_in 32 * 9
    std = 1.0 / np.sqrt(32 * 9)
    assert abs(float(w.std()) - std) < 0.1 * std and float(w.abs().max()) <= 2 * std / 0.8797 + 1e-6
    assert torch.all(model.gn_stem.weight == 1) and torch.all(model.gn_stem.bias == 0)
    assert torch.all(model.classifier.bias == 0)
    assert ResNet(ResNetConfig.tiny(), device="cpu", seed=0).state_dict().keys() == \
        ResNet(ResNetConfig.tiny(), device="cpu", seed=1).state_dict().keys()


class _Dtypes(TorchFunctionMode):
    """The dtypes each GroupNorm, linear and convolution call sees."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("group_norm", "linear", "conv2d"):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            self.seen.setdefault(name, set()).update(t.dtype for t in tensors)
        return func(*args, **(kwargs or {}))


def test_bf16_policy_keeps_group_norm_and_the_classifier_in_fp32():
    acc = Accelerator(mixed_precision="bf16", device="cpu")
    model = acc.prepare(ResNet(ResNetConfig.tiny(), device="cpu"))
    assert model.compute_params()["gn_stem.weight"].dtype == torch.bfloat16
    with _Dtypes() as mode:
        logits = model(torch.from_numpy(_batch(32)["image"]))
    assert mode.seen["group_norm"] == {torch.float32}
    assert mode.seen["linear"] == {torch.float32}
    assert mode.seen["conv2d"] == {torch.bfloat16}
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
