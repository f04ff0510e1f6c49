"""The port's checkpoints (`accelerate_tpu_torch.checkpointing`,
``Accelerator.save_state``/``load_state``/``save_model``) on the CPU.

Port against port: a loop saved mid-epoch and rebuilt from nothing resumes
to the losses of the loop that never stopped (AdamW's moments, the
scheduler's count, the loader's position, the RNG, a custom object and the
step all come back); automatic naming keeps ``total_limit`` complete
directories, and ``load_state(None)`` skips torn and corrupt ones; an async
save lands the values of the moment it was called. Port against reference:
a ``save_model`` export round-trips in both directions through the two
packages' ``load_model_weights``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from accelerate_tpu import checkpointing as jax_ckpt  # noqa: E402
from accelerate_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from accelerate_tpu.models.bert import BertForSequenceClassification as JaxBert  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2Config as JaxGPT2Config  # noqa: E402
from accelerate_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead  # noqa: E402
from accelerate_tpu.state import PartialState  # noqa: E402
from accelerate_tpu_torch import checkpointing  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, ProjectConfiguration  # noqa: E402
from accelerate_tpu_torch.data_loader import DataLoaderShard  # noqa: E402
from accelerate_tpu_torch.models import bert, gpt2  # noqa: E402
from accelerate_tpu_torch.scheduler import schedule_lambda  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

N_BATCHES, BREAK, K = 8, 4, 2


def _batches(seed=0):
    r = np.random.default_rng(seed)
    return [{"input_ids": r.integers(0, 1024, (4, 16)).astype(np.int32),
             "labels": r.integers(0, 2, (4,)).astype(np.int32)} for _ in range(N_BATCHES)]


class Counter:
    """A custom object registered for checkpointing."""

    def __init__(self):
        self.n = 0

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, state):
        self.n = state["n"]


def _loss_fn(bound, batch):
    # a draw from the global RNG: the resumed run must draw what the
    # uninterrupted one drew
    noise = torch.rand(()) * 1e-3
    return bert.classification_loss_fn(bound, batch) + noise


def _build(project_dir, seed):
    set_seed(seed)
    acc = Accelerator(gradient_accumulation_steps=K, device="cpu",
                      project_config=ProjectConfiguration(project_dir=str(project_dir),
                                                          automatic_checkpoint_naming=True))
    module = bert.BertForSequenceClassification(bert.BertConfig.tiny(dtype=torch.float32),
                                                device="cpu", seed=seed)
    opt = torch.optim.AdamW(module.parameters(), weight_decay=1e-4)
    sched = schedule_lambda(opt, lambda n: 1e-3 / (1 + n))
    model, opt, dl, sched = acc.prepare(module, opt, DataLoaderShard(_batches()), sched)
    counter = Counter()
    acc.register_for_checkpointing(counter)
    return acc, model, opt, dl, sched, counter


def _train(acc, model, opt, dl, sched, counter, stop=None):
    losses = []
    for i, batch in enumerate(dl):
        with acc.accumulate(model):
            losses.append(float(acc.backward(_loss_fn, batch)))
            if acc.sync_gradients:
                acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            sched.step()
            opt.zero_grad()
        counter.n += 1
        if stop is not None and i + 1 == stop:
            break
    return losses


def test_resume_equals_no_break(tmp_path):
    run = _build(tmp_path / "a", seed=0)
    want = _train(*run) + _train(*run)  # two epochs, never stopped

    first = _build(tmp_path / "b", seed=0)
    got = _train(*first, stop=BREAK)
    saved = first[0].save_state()
    assert saved.endswith("checkpoint_0")
    # a run rebuilt from nothing, from another seed: everything comes from the checkpoint
    acc, model, opt, dl, sched, counter = _build(tmp_path / "b", seed=99)
    assert acc.load_state() == saved
    assert counter.n == acc.step == BREAK
    assert sched.scheduler.last_epoch == BREAK // K and opt.num_updates == BREAK // K
    acc.skip_first_batches(dl, BREAK)
    got += _train(acc, model, opt, dl, sched, counter) + _train(acc, model, opt, dl, sched, counter)
    assert got == want  # bit for bit on the CPU


def test_rotation_keeps_total_limit_complete_directories(tmp_path):
    acc = Accelerator(device="cpu", project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=2))
    module = torch.nn.Linear(3, 2)
    model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    weights = []
    for i in range(4):
        with torch.no_grad():
            module.weight.fill_(float(i))
        weights.append(acc.save_state())
    base = tmp_path / "checkpoints"
    assert sorted(d.name for d in base.iterdir()) == ["checkpoint_2", "checkpoint_3"]
    assert all((base / d / "_COMPLETE").exists() for d in ("checkpoint_2", "checkpoint_3"))
    assert [d.name for d in checkpointing.complete_checkpoint_dirs(acc)] == ["checkpoint_3",
                                                                             "checkpoint_2"]
    # a torn directory (no marker) is never offered
    (base / "checkpoint_9").mkdir()
    assert acc.load_state() == weights[3] and module.weight[0, 0].item() == 3.0
    # a corrupt newest checkpoint falls back to the one before, with a warning
    (base / "checkpoint_3" / "model_0.safetensors").write_bytes(b"\0\0")
    with pytest.warns(UserWarning, match="falling back"):
        assert acc.load_state() == weights[2]
    assert module.weight[0, 0].item() == 2.0


def test_async_save_writes_the_values_of_the_call(tmp_path):
    acc = Accelerator(device="cpu", project_dir=str(tmp_path))
    module = torch.nn.Linear(3, 2)
    acc.prepare(module)
    seen = []
    acc.register_save_state_pre_hook(lambda models, weights, out: seen.append(out))
    handle = acc.register_load_state_pre_hook(lambda models, src: seen.append(("load", src)))
    with torch.no_grad():
        module.weight.fill_(1.0)
    out = acc.save_state(async_save=True)
    with torch.no_grad():
        module.weight.fill_(2.0)  # after the call: not in the checkpoint
    acc.wait_for_checkpoint()
    assert (tmp_path / "checkpoints" / "_COMPLETE").exists() and seen == [out]
    acc.load_state(out)
    assert module.weight.unique().tolist() == [1.0] and seen[-1] == ("load", out)
    handle.remove()
    acc.load_state(out)
    assert len(seen) == 2
    # one custom object alone
    counter = Counter()
    counter.n = 7
    path = checkpointing.save_custom_state(counter, tmp_path, index=3)
    assert path.endswith("custom_checkpoint_3.pkl")
    fresh = Counter()
    checkpointing.load_custom_state(fresh, tmp_path, index=3)
    assert fresh.n == 7
    assert acc.free_memory(module) == (module,) and acc._models == []


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["bert", "gpt2"])
def test_save_model_round_trips_through_both_packages(tmp_path, name):
    if name == "bert":
        jmod = JaxBert(JaxBertConfig.tiny(dtype=jnp.float32))
        module = bert.BertForSequenceClassification(bert.BertConfig.tiny(), device="cpu", seed=1)
        from_jax = bert.params_from_jax
    else:
        jmod = JaxGPT2LMHead(JaxGPT2Config.tiny(dtype=jnp.float32, attention_impl="xla"))
        module = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(), device="cpu", seed=1)
        from_jax = gpt2.params_from_jax
    want = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(0), batch=1, seq=8))

    # port -> reference: the reference reads the port's export as its own tree
    acc = Accelerator(device="cpu")
    model = acc.prepare(module)
    acc.save_model(model, tmp_path / "port", max_shard_size=4096)  # sharded, with an index
    assert (tmp_path / "port" / "model.safetensors.index.json").exists()
    PartialState._reset_state()
    back = jax_ckpt.load_model_weights(str(tmp_path / "port"))
    mine = _flat(jax.tree.map(np.asarray, module.reference_state_dict()))
    assert _flat(back).keys() == _flat(want).keys() == mine.keys()
    for key, value in _flat(back).items():
        np.testing.assert_array_equal(value, mine[key], err_msg=key)

    # reference -> port: the reference's export loads into the port's module
    jax_ckpt.save_model_weights(want, str(tmp_path / "ref"))
    loaded = checkpointing.load_model_weights(tmp_path / "ref")
    module.load_state_dict(from_jax(loaded))
    for key, value in _flat(jax.tree.map(np.asarray, module.reference_state_dict())).items():
        np.testing.assert_array_equal(value, _flat(want)[key], err_msg=key)
    with pytest.raises(ValueError, match="msgpack"):
        acc.save_model(model, tmp_path / "m", safe_serialization=False)
