"""The port's ViT (`accelerate_tpu_torch.models.vit`) against the reference's,
on the CPU, and the port's one-process inference examples.

`patchify` against the reference's and a strided convolution; tiny ViT
fp32 and bf16 logits from the reference's weights carried by
`params_from_jax`; `vit_loss_fn` and every gradient against ``jax.grad``;
three AdamW `make_train_step` steps against the JAX step; `params_from_hf_vit`
on a synthetic Hugging Face state dict; the `params_to_jax` round trip; the
refusals. Then `examples/inference/distributed/image_classification.py` and
`batch_text_generation.py` on the CPU, in-process and from the command line.
"""

import argparse
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator  # noqa: E402
from accelerate_tpu.models import vit as jvit  # noqa: E402
from accelerate_tpu.state import AcceleratorState, GradientState, PartialState  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.examples.inference.distributed import (  # noqa: E402
    batch_text_generation,
    image_classification,
)
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead  # noqa: E402
from accelerate_tpu_torch.models.vit import (  # noqa: E402
    ViTConfig,
    ViTForImageClassification,
    params_from_hf_vit,
    params_from_jax,
    patchify,
    vit_loss_fn,
    vit_sharding_rules,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
B = 4
# fp32 on both sides: matmuls, LayerNorms (flax's E[x^2] - E[x]^2 variance
# against torch's) and softmaxes reduce in other orders
LOGIT_ATOL = 1e-5
LOSS_ATOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# bf16 compute over the same fp32 masters in both packages: logits of size
# ~1, each bf16 rounding 2^-8 relative, summed in other orders
BF16_LOGIT_ATOL = 3e-2
# 3 AdamW steps at lr 1e-2, eps 1e-4 (as tests/test_torch_t5.py)
ADAM_EPS = 1e-4
PARAM_ATOL = 5e-4


def _jcfg(**kw):
    return jvit.ViTConfig.tiny(**{"dtype": jnp.float32, **kw})


@pytest.fixture(scope="module")
def tree():
    p = jvit.ViTForImageClassification(_jcfg()).init_params(jax.random.key(0), batch=1)
    # the reference starts with a zero CLS token and zero biases: give them
    # values, so a wrong placement shows
    leaves, treedef = jax.tree_util.tree_flatten(p)
    r = np.random.default_rng(0)
    leaves = [np.asarray(x) + 0.02 * r.standard_normal(x.shape).astype(np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _port(tree, **kw):
    model = ViTForImageClassification(ViTConfig.tiny(**{"dtype": torch.float32, **kw}),
                                      device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _images(seed, b=B):
    return np.random.default_rng(seed).standard_normal((b, 3, 32, 32)).astype(np.float32)


def test_patchify_matches_reference_and_conv():
    img = _images(1, b=2)
    got = patchify(torch.from_numpy(img), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvit.patchify(jnp.asarray(img), 8)))
    conv = torch.nn.Conv2d(3, 5, kernel_size=8, stride=8)
    with torch.no_grad():
        ref = conv(torch.from_numpy(img)).flatten(2).transpose(1, 2)
        ours = got @ conv.weight.reshape(5, -1).T + conv.bias
    torch.testing.assert_close(ours, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_reference(tree, dtype):
    img = _images(2)
    want = jvit.ViTForImageClassification(_jcfg(dtype=getattr(jnp, dtype))).apply(
        {"params": tree}, jnp.asarray(img))
    with torch.no_grad():
        got = _port(tree, dtype=getattr(torch, dtype))(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    atol = LOGIT_ATOL if dtype == "float32" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def test_loss_and_every_gradient_match(tree):
    jmod = jvit.ViTForImageClassification(_jcfg())
    img, labels = _images(3), np.array([1, 7, 3, 3], np.int32)

    def jloss(p):
        return jvit.vit_loss_fn(lambda x: jmod.apply({"params": p}, x),
                                {"pixel_values": jnp.asarray(img), "labels": jnp.asarray(labels)})

    want_loss, want_grads = jax.value_and_grad(jloss)(tree)
    model = _port(tree)
    loss = vit_loss_fn(model, {"pixel_values": torch.from_numpy(img),
                               "labels": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    named = dict(model.named_parameters())
    assert sorted(want) == sorted(named)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_three_train_steps_match_and_the_loss_falls(tree):
    batch = {"pixel_values": _images(4), "labels": np.array([0, 5, 9, 2], np.int32)}
    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()
    jacc = JaxAccelerator(mixed_precision="no")
    jmodel, _ = jacc.prepare((jvit.ViTForImageClassification(_jcfg()), tree),
                             optax.adamw(1e-2, eps=ADAM_EPS))
    jstep = jacc.make_train_step(jvit.vit_loss_fn, max_grad_norm=1.0)
    want_losses = [float(jstep({k: jnp.asarray(v) for k, v in batch.items()})) for _ in range(3)]
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params))

    model = _port(tree)
    acc = Accelerator(mixed_precision="no", device="cpu")
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                                    weight_decay=1e-4, eps=ADAM_EPS))
    step = acc.make_train_step(vit_loss_fn, max_grad_norm=1.0)
    losses = [step({k: torch.from_numpy(v) for k, v in batch.items()}).item() for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=0)
    assert losses[-1] < losses[0]
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_params_from_hf_vit_on_synthetic_state_dict():
    """A Hugging Face-named state dict (``[out, in]`` Linear weights, the
    patch convolution ``[hidden, C, ph, pw]``) maps to the tree the
    reference's mapping gives, and the model's patch projection equals the
    convolution."""
    rng = np.random.default_rng(9)
    e, f = 64, 256

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    hf = {"vit.embeddings.patch_embeddings.projection.weight": w(e, 3, 8, 8),
          "vit.embeddings.patch_embeddings.projection.bias": w(e),
          "vit.embeddings.cls_token": w(1, 1, e), "vit.embeddings.position_embeddings": w(1, 17, e),
          "vit.layernorm.weight": 1 + w(e), "vit.layernorm.bias": w(e),
          "classifier.weight": w(10, e), "classifier.bias": w(10)}
    for i in range(2):
        pre = f"vit.encoder.layer.{i}."
        for name, shape in (("attention.attention.query", (e, e)),
                            ("attention.attention.key", (e, e)),
                            ("attention.attention.value", (e, e)),
                            ("attention.output.dense", (e, e)), ("intermediate.dense", (f, e)),
                            ("output.dense", (e, f))):
            hf[f"{pre}{name}.weight"], hf[f"{pre}{name}.bias"] = w(*shape), w(shape[0])
        for ln in ("layernorm_before", "layernorm_after"):
            hf[f"{pre}{ln}.weight"], hf[f"{pre}{ln}.bias"] = 1 + w(e), w(e)
    tree = jvit.params_from_hf_vit(hf, _jcfg())
    got = params_from_hf_vit({k: torch.from_numpy(x) for k, x in hf.items()},
                             ViTConfig.tiny(dtype=torch.float32))
    want = params_from_jax(tree)
    assert sorted(got) == sorted(want)
    for name in got:
        assert torch.equal(got[name], want[name]), name
    model = _port(tree)
    img = torch.from_numpy(_images(5, b=2))
    conv = torch.nn.functional.conv2d(
        img, torch.from_numpy(hf["vit.embeddings.patch_embeddings.projection.weight"]),
        torch.from_numpy(hf["vit.embeddings.patch_embeddings.projection.bias"]), stride=8)
    with torch.no_grad():
        ours = model.patch_embed(patchify(img, 8))
    torch.testing.assert_close(ours, conv.flatten(2).transpose(1, 2), atol=1e-5, rtol=1e-5)


def test_params_to_jax_inverts_params_from_jax(tree):
    back = _port(tree).reference_state_dict()
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert set(flat_back) == set(flat_want)
    for key, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_back[key].numpy(), leaf, err_msg=str(key))


def test_seeded_init_and_refusals(monkeypatch):
    a = ViTForImageClassification(ViTConfig.tiny(), device="cpu", seed=3)
    b = ViTForImageClassification(ViTConfig.tiny(), device="cpu", seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert ViTConfig.base().num_patches == 196 and ViTConfig.large().hidden_size == 1024
    with pytest.raises(NotImplementedError, match="21.3"):
        vit_sharding_rules()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ViTForImageClassification(ViTConfig.tiny())


def test_inference_examples_in_process(capsys):
    """The image example's 10 predictions are the ViT's argmax over its own
    images; the text example's completions are `generate`'s for each prompt
    alone."""
    preds = image_classification.run(argparse.Namespace(num_images=10, seed=0, device="cpu"))
    model = ViTForImageClassification(ViTConfig.tiny(), device="cpu", seed=0)
    images = np.random.default_rng(0).normal(size=(10, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        assert preds == model(torch.from_numpy(images)).argmax(-1).tolist()
    rows = batch_text_generation.run(argparse.Namespace(max_new_tokens=8, seed=0, device="cpu"))
    gpt2 = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu", seed=0)
    assert len(rows) == 5 and all(len(r) == 8 for r in rows)
    for prompt, row in zip(batch_text_generation.PROMPTS, rows):
        assert generate(gpt2, torch.tensor([prompt]), 8, device="cpu")[0].tolist() == row
    out = capsys.readouterr().out
    assert "10 predictions from 1 process(es):" in out and "prompt 4: +" in out


def test_inference_examples_from_the_command_line():
    procs = [subprocess.Popen([sys.executable, "-m",
                               f"accelerate_tpu_torch.examples.inference.distributed.{name}",
                               "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name in ("image_classification", "batch_text_generation")]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0].splitlines()[0] == "10 predictions from 1 process(es):"
    assert len(ast.literal_eval(outs[0][0].splitlines()[1])) == 10
    assert [line.split(":")[0] for line in outs[1][0].splitlines()] == [
        f"prompt {i}" for i in range(5)]
