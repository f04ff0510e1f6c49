"""The port's big-model placement against the reference's, on the CPU.

Every test of `tests/test_big_modeling.py` has its counterpart here: the
solver gives the reference's device map key for key on the same trees (the
reference's numpy leaves, the port's torch tensors over the same memory);
blockwise GPT-2, Llama, BERT and Mixtral dispatched over device, cpu and
disk tiers give the JAX model's output within the reference's own 2e-5,
from the reference's weights carried over by each model's
`params_from_jax`; a split block across two calls; the offload helpers,
`load_checkpoint_and_dispatch`, the hooks on a `PreparedModel` and
`cpu_offload_with_hook`; and offload folders written by each package and
read by the other. On the CPU the ``device`` tier is host memory: the
streaming path itself runs on the card (`tests/test_torch_cuda_big_modeling.py`).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import accelerate_tpu.big_modeling as jbm  # noqa: E402
import accelerate_tpu.utils.modeling as jmodeling  # noqa: E402
import accelerate_tpu.utils.offload as joffload  # noqa: E402
from accelerate_tpu.models import bert as jbert  # noqa: E402
from accelerate_tpu.models import gpt2 as jgpt2  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.models import mixtral as jmixtral  # noqa: E402
from accelerate_tpu_torch import big_modeling as bm  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator  # noqa: E402
from accelerate_tpu_torch.checkpointing import save_model_weights  # noqa: E402
from accelerate_tpu_torch.hooks import (  # noqa: E402
    AlignDevicesHook,
    ModelHook,
    SequentialHook,
    add_hook_to_module,
    remove_hook_from_module,
)
from accelerate_tpu_torch.models import bert, gpt2, llama, mixtral  # noqa: E402
from accelerate_tpu_torch.utils import modeling, offload  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# the reference's own bar for blockwise against monolithic outputs, fp32
ATOL = RTOL = 2e-5


def _torch_tree(tree):
    """The numpy tree as torch tensors over the same memory, so leaves the
    reference sees tied (one array at two paths) are tied for the port."""
    memo = {}

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if id(x) not in memo:
            memo[id(x)] = torch.from_numpy(x)
        return memo[id(x)]

    return conv(tree)


@pytest.fixture(scope="module")
def tiny_gpt2():
    """The reference's fixture: tiny fp32 GPT-2, its params and logits on a
    1 x 32 prompt, and the port's blockwise state dict of the same weights."""
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    module = jgpt2.GPT2LMHead(cfg)
    params = module.init_params(jax.random.key(0))
    ids = np.arange(32).reshape(1, 32) % cfg.vocab_size
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids, jnp.int32)))
    params = jax.tree.map(np.asarray, params)
    model = gpt2.GPT2LMHead(gpt2.GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(gpt2.params_from_jax(params))
    sd = gpt2.gpt2_blockwise_state_dict(model.state_dict())
    return model.config, params, sd, torch.from_numpy(ids), ref


def _close(out, ref):
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=RTOL)


def test_init_empty_weights_no_allocation():
    jcfg = jgpt2.GPT2Config.tiny()
    with jbm.init_empty_weights() as jmeta:
        abstract = jmeta.init(jgpt2.GPT2LMHead(jcfg), jax.random.key(0),
                              jnp.zeros((1, 8), dtype=jnp.int32))
    with bm.init_empty_weights() as meta:
        model = meta.init(gpt2.GPT2LMHead, gpt2.GPT2Config.tiny())
        loose = torch.empty(3)
    params = list(model.parameters())
    assert all(p.device.type == "meta" for p in params) and loose.device.type == "meta"
    assert len(params) > 10
    # the same parameters, by count and size
    assert sum(p.numel() for p in params) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(abstract))
    assert len(params) == len(jax.tree.leaves(abstract))


def test_flatten_unflatten_roundtrip(tiny_gpt2):
    _, _, sd, _, _ = tiny_gpt2
    flat = modeling.flatten_params(sd)
    rebuilt = modeling.unflatten_params(flat)
    assert modeling.flatten_params(rebuilt).keys() == flat.keys()
    for k, v in modeling.flatten_params(rebuilt).items():
        assert v is flat[k]
    # the reference's converters on the same tree of arrays
    jflat = jmodeling.flatten_params(jax.tree.map(np.asarray, sd))
    assert sorted(jflat) == sorted(flat)


def test_module_sizes_and_maximum(tiny_gpt2):
    _, params, sd, _, _ = tiny_gpt2
    sizes = modeling.compute_module_sizes(sd)
    total, (largest, name) = modeling.calculate_maximum_sizes(sd)
    assert sizes[""] == total
    assert largest > 0 and name in modeling.flatten_params(sd)
    assert sizes["block_0"] > 0
    # per block, the bytes of the reference's blockwise layout
    jsizes = jmodeling.compute_module_sizes(jgpt2.gpt2_blockwise_state_dict(params))
    for block in ("embed", "block_0", "block_1", "head", ""):
        assert sizes[block] == jsizes[block]
    assert largest == jmodeling.calculate_maximum_sizes(params)[1][0]


def test_find_tied_parameters():
    shared = np.ones((4, 4))
    params = {"a": {"w": shared}, "b": {"w": shared}, "c": np.zeros(2)}
    assert jmodeling.find_tied_parameters(params) == [["a/w", "b/w"]]
    assert modeling.find_tied_parameters(_torch_tree(params)) == [["a/w", "b/w"]]
    # a second view of the same memory is tied too; another shape of it is not
    t = torch.ones(4, 4)
    assert modeling.find_tied_parameters(
        {"a": t, "b": t.view(4, 4), "c": t.view(16)}) == [["a", "b"]]


def test_infer_auto_device_map_tiers(tiny_gpt2):
    """embed and head share the tied wte: one unit, wte counted once, so both
    land on device:0; the two packages solve the same map."""
    _, params, sd, _, _ = tiny_gpt2
    sizes = modeling.compute_module_sizes(sd)
    wte = sizes["embed/wte"]
    unit = sizes["embed"] + sizes["head"] - wte
    budget = {"device:0": unit + 1, "cpu": sizes["block_0"] + 1, "disk": 1 << 62}
    no_split = ["embed", "head", "block_"]
    dmap = bm.infer_auto_device_map(sd, max_memory=budget, no_split_module_classes=no_split)
    assert dmap == {"embed": "device:0", "head": "device:0", "block_0": "cpu", "block_1": "disk"}
    jdmap = jbm.infer_auto_device_map(jgpt2.gpt2_blockwise_state_dict(params), max_memory=budget,
                                      no_split_module_classes=no_split)
    assert dmap == jdmap


def _solver_params(a=100, b=100, c=100):
    return {"a": {"w": np.zeros((a,), np.float32)}, "b": {"w": np.zeros((b,), np.float32)},
            "c": {"w": np.zeros((c,), np.float32)}}


def _big_small():
    return {"big": {"x": np.zeros(100, np.float32), "y": np.zeros(100, np.float32)},
            "small": {"w": np.zeros(10, np.float32)}}


def _tied():
    shared = np.zeros(100, np.float32)
    return {"a": {"w": shared}, "b": {"w": np.zeros(100, np.float32)}, "c": {"w": shared}}


SOLVER_CASES = {
    "per_device_budgets": (_solver_params, dict(
        max_memory={"device:0": 450, "device:1": 450, "cpu": 10_000}),
        {"a": "device:0", "b": "device:1", "c": "cpu"}),
    "split_oversized": (_big_small, dict(
        max_memory={"device:0": 450, "cpu": 10_000}, clean_result=False),
        {"big/x": "device:0", "big/y": "cpu", "small": "cpu"}),
    "no_backfill": (lambda: {"a": {"w": np.zeros(100, np.float32)},
                             "b": {"w": np.zeros(100, np.float32)},
                             "c": {"w": np.zeros(10, np.float32)}},
                    dict(max_memory={"device:0": 450, "device:1": 1000, "cpu": 10_000}),
                    {"a": "device:0", "b": "device:1", "c": "device:1"}),
    "no_split": (_big_small, dict(max_memory={"device:0": 450, "cpu": 10_000},
                                  no_split_module_classes=["big"]),
                 {"big": "cpu", "small": "cpu"}),
    "tied_unit": (_tied, dict(max_memory={"device:0": 450, "cpu": 10_000}),
                  {"a": "device:0", "c": "device:0", "b": "cpu"}),
    "pooled_device_and_disk": (_solver_params, dict(max_memory={"device": 450, "cpu": 450}),
                               {"a": "device", "b": "cpu", "c": "disk"}),
    "split_then_clean": (_big_small, dict(max_memory={"device:0": 300, "cpu": 10_000}),
                         {"big": "cpu", "small": "cpu"}),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_device_map_solver_matches_reference(case):
    make, kwargs, expected = SOLVER_CASES[case]
    params = make()
    want = jbm.infer_auto_device_map(params, **kwargs)
    got = bm.infer_auto_device_map(_torch_tree(params), **kwargs)
    assert got == want == expected
    assert list(got) == list(want)  # the same order of entries too


def test_clean_device_map_merges_uniform_children():
    dmap = {"m/x": "cpu", "m/y": "cpu", "n": "device:0", "p/q/r": "disk", "p/q/s": "disk",
            "p/t": "cpu"}
    assert bm.clean_device_map(dict(dmap)) == jbm.clean_device_map(dict(dmap)) == {
        "m": "cpu", "n": "device:0", "p/q": "disk", "p/t": "cpu"}


def test_balanced_memory_covers_largest_block():
    p = {"big": {"w": np.zeros(1000, np.float32)}, "s": {"w": np.zeros(10, np.float32)}}
    for low_zero in (False, True):
        budget = modeling.get_balanced_memory(_torch_tree(p), num_devices=4, low_zero=low_zero)
        want = jmodeling.get_balanced_memory(p, num_devices=4, low_zero=low_zero)
        assert {k: v for k, v in budget.items() if k.startswith("device")} == {
            k: v for k, v in want.items() if k.startswith("device")}
        assert all(budget[f"device:{i}"] >= 4000 for i in range(1, 4))
        assert budget["disk"] == want["disk"] == 1 << 62
    assert budget["device:0"] < budget["device:1"]


def test_balanced_budget_spreads_blocks():
    p = {f"l{i}": {"w": np.zeros(100, np.float32)} for i in range(4)}
    budget = modeling.get_balanced_memory(_torch_tree(p), num_devices=2)
    budget.pop("cpu"), budget.pop("disk")
    dmap = bm.infer_auto_device_map(_torch_tree(p), max_memory={**budget, "cpu": 1 << 40})
    assert {v for v in dmap.values()} == {"device:0", "device:1"}
    assert dmap == jbm.infer_auto_device_map(p, max_memory={**budget, "cpu": 1 << 40})


def test_get_max_memory_tiers():
    got = modeling.get_max_memory()
    assert got["disk"] == 1 << 62 and got["cpu"] > 0
    assert sorted(k for k in got if k.startswith("device")) == [
        f"device:{i}" for i in range(torch.cuda.device_count())]
    assert modeling.get_max_memory({"device": 5, "cpu": 6}) == {"device": 5, "cpu": 6}


def _mixed_map(names):
    return {n: ("device" if i % 3 == 0 else "cpu" if i % 3 == 1 else "disk")
            for i, n in enumerate(names)}


@pytest.mark.parametrize("mode", ["device", "cpu", "disk", "mixed"])
def test_blockwise_dispatch_matches_full(tiny_gpt2, tmp_path, mode):
    cfg, _, sd, ids, ref = tiny_gpt2
    bw = gpt2.gpt2_blockwise(cfg)
    names = [n for n, _ in bw.block_fns]
    dmap = _mixed_map(names) if mode == "mixed" else {n: mode for n in names}
    bw = bm.dispatch_model(bw, dmap, sd, offload_dir=str(tmp_path / "offload"), device="cpu")
    with torch.no_grad():
        _close(bw(ids), ref)


FAMILIES = {
    "llama": (jllama.LlamaConfig, jllama.LlamaForCausalLM, llama.LlamaConfig,
              llama.LlamaForCausalLM, llama.params_from_jax, llama.llama_blockwise,
              llama.llama_blockwise_state_dict, dict(param_dtype=jnp.float32)),
    "bert": (jbert.BertConfig, jbert.BertForSequenceClassification, bert.BertConfig,
             bert.BertForSequenceClassification, bert.params_from_jax, bert.bert_blockwise,
             bert.bert_blockwise_state_dict, {}),
    "mixtral": (jmixtral.MixtralConfig, jmixtral.MixtralForCausalLM, mixtral.MixtralConfig,
                mixtral.MixtralForCausalLM, mixtral.params_from_jax, mixtral.mixtral_blockwise,
                mixtral.mixtral_blockwise_state_dict, dict(param_dtype=jnp.float32)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_new_blockwise_families_offload_stream(family, tmp_path):
    """Mixed device/cpu/disk tiers over each family's blockwise decomposition
    give the reference model's output."""
    jcfg_cls, jmod_cls, cfg_cls, cls, from_jax, bw_fn, sd_fn, jkw = FAMILIES[family]
    jcfg = jcfg_cls.tiny(num_layers=3, dtype=jnp.float32, **jkw)
    jmod = jmod_cls(jcfg)
    params = jmod.init_params(jax.random.key(7))
    ids = np.random.default_rng(7).integers(0, 200, (2, 12))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids, jnp.int32)))
    cfg = cfg_cls.tiny(num_layers=3, dtype=torch.float32)
    model = cls(cfg, device="meta")
    model.load_state_dict(from_jax(jax.tree.map(np.asarray, params)), assign=True)
    bw = bw_fn(cfg)
    dmap = _mixed_map([n for n, _ in bw.block_fns])
    bw = bm.dispatch_model(bw, dmap, sd_fn(model.state_dict()),
                           offload_dir=str(tmp_path / "offload"), device="cpu")
    with torch.no_grad():
        _close(bw(torch.from_numpy(ids)), ref)


def test_split_block_device_map_dispatch(tiny_gpt2, tmp_path):
    """A split block, its entries on three tiers, is assembled per call, and
    a second call still agrees (the resident parts were kept)."""
    cfg, _, sd, ids, ref = tiny_gpt2
    bw = gpt2.gpt2_blockwise(cfg)
    dmap = {n: "device" for n, _ in bw.block_fns}
    del dmap["block_1"]
    dmap.update({"block_1/ln_1": "device:0", "block_1/ln_2": "cpu", "block_1/attn": "cpu",
                 "block_1/mlp": "disk"})
    bw = bm.dispatch_model(bw, dmap, sd, offload_dir=str(tmp_path / "off"), device="cpu")
    for _ in range(2):
        with torch.no_grad():
            _close(bw(ids), ref)
    with pytest.raises(ValueError, match="different topology"):
        bm.dispatch_model(gpt2.gpt2_blockwise(cfg), {**dmap, "block_0": "device:1"}, sd,
                          offload_dir=str(tmp_path / "off2"), device="cpu")


def test_cpu_and_disk_offload_helpers(tiny_gpt2, tmp_path):
    cfg, _, sd, ids, ref = tiny_gpt2
    with torch.no_grad():
        _close(bm.cpu_offload(gpt2.gpt2_blockwise(cfg), sd, device="cpu")(ids), ref)
        bw2 = bm.disk_offload(gpt2.gpt2_blockwise(cfg), sd, str(tmp_path / "disk"), device="cpu")
        _close(bw2(ids), ref)
    assert set(offload.load_offload_index(str(tmp_path / "disk"))) == set(
        modeling.flatten_params(sd)) - {"head/wte/weight"} | {"head/wte/weight"}


def test_load_checkpoint_and_dispatch(tiny_gpt2, tmp_path):
    cfg, _, sd, ids, ref = tiny_gpt2
    save_model_weights(sd, str(tmp_path / "export"))
    sizes = modeling.compute_module_sizes(sd)
    budget = {"device": sizes["embed"] + sizes["head"] - sizes["embed/wte"] + 1,
              "cpu": sizes["block_0"] + 1}
    bw = bm.load_checkpoint_and_dispatch(
        gpt2.gpt2_blockwise(cfg), str(tmp_path / "export"), device_map="auto",
        max_memory=budget, offload_folder=str(tmp_path / "offload"), device="cpu")
    assert set(bw.device_map.values()) == {"device", "cpu", "disk"}
    with torch.no_grad():
        _close(bw(ids), ref)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bm.load_checkpoint_and_dispatch(gpt2.gpt2_blockwise(cfg), str(tmp_path / "export"),
                                        device_map="auto", max_memory=budget,
                                        offload_folder=str(tmp_path / "offload2"))


class _Scale(torch.nn.Module):
    def __init__(self, device="cpu"):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor([2.0], device=device))

    def forward(self, x):
        return self.w * x


def test_hooks_on_prepared_model():
    model = Accelerator(device="cpu").prepare_model(_Scale())
    calls = []

    class Doubler(ModelHook):
        def pre_forward(self, model, params, args, kwargs):
            calls.append("pre")
            return {k: v * 2 for k, v in params.items()}, args, kwargs

        def post_forward(self, model, output):
            calls.append("post")
            return output + 1

    add_hook_to_module(model, Doubler())
    np.testing.assert_allclose(model(torch.tensor([3.0])).detach().numpy(), [13.0])
    assert calls == ["pre", "post"]
    add_hook_to_module(model, Doubler(), append=True)
    assert isinstance(model._hook, SequentialHook)
    # both hooks: (2 * 2 * 2) * 3 + 1 + 1
    np.testing.assert_allclose(model(torch.tensor([3.0])).detach().numpy(), [26.0])
    remove_hook_from_module(model)
    np.testing.assert_allclose(model(torch.tensor([3.0])).detach().numpy(), [6.0])


def test_align_devices_hook_streams_offloaded_weights(tmp_path):
    """A weightless module prepared on ``meta`` runs on weights read from an
    offload folder for each call, as the reference's AlignDevicesHook."""
    offload.offload_state_dict(str(tmp_path), {"w": torch.tensor([5.0])})
    model = Accelerator(device="cpu").prepare_model(_Scale())
    hook = AlignDevicesHook(execution_device="cpu",
                            weights_map=offload.OffloadedWeightsLoader(save_folder=str(tmp_path)))
    add_hook_to_module(model, hook)
    np.testing.assert_allclose(model(torch.tensor([3.0])).detach().numpy(), [15.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlignDevicesHook()


class _CountingMap(dict):
    def __init__(self, *args):
        super().__init__(*args)
        self.reads = 0

    def __getitem__(self, key):
        self.reads += 1
        return super().__getitem__(key)


@pytest.mark.parametrize("offload_after", [True, False])
def test_align_devices_hook_offload_flag(offload_after):
    """``offload=True`` reads the weights map on every call; ``offload=False``
    reads it once and runs later calls on the same device copies, until the
    hook is detached."""
    model = Accelerator(device="cpu").prepare_model(_Scale())
    weights = _CountingMap({"w": torch.tensor([5.0])})
    hook = AlignDevicesHook(execution_device="cpu", offload=offload_after, weights_map=weights)
    add_hook_to_module(model, hook)
    for _ in range(3):
        np.testing.assert_allclose(model(torch.tensor([3.0])).detach().numpy(), [15.0])
    assert weights.reads == (3 if offload_after else 1)
    remove_hook_from_module(model)
    add_hook_to_module(model, hook)
    model(torch.tensor([3.0]))
    assert weights.reads == (4 if offload_after else 2)


def test_cpu_offload_with_hook_pipeline(tiny_gpt2):
    cfg, _, sd, ids, ref = tiny_gpt2
    m1, hook1 = bm.cpu_offload_with_hook(gpt2.gpt2_blockwise(cfg), sd, device="cpu")
    m2, hook2 = bm.cpu_offload_with_hook(gpt2.gpt2_blockwise(cfg), sd, prev_module_hook=hook1,
                                         device="cpu")
    with torch.no_grad():
        _close(m1(ids), ref)
        assert m1._cache, "weights should stay resident after the call"
        _close(m2(ids), ref)  # entering m2 evicts m1
        assert not m1._cache and m2._cache
        _close(m1(ids), ref)
    hook1.remove()
    assert not m1.cache_resident and not m1._cache


def _offload_tree():
    rng = np.random.default_rng(3)
    return {"a/w": rng.standard_normal((3, 5)).astype(np.float32),
            "a/ids": rng.integers(0, 9, (4,)).astype(np.int32),
            "b/half": rng.standard_normal((2, 3)).astype(np.float16),
            "b/scalar": np.asarray(2.5, np.float32),
            "c/bf16": rng.standard_normal((4, 6)).astype(np.float32)}


def test_offload_folder_written_by_either_package(tmp_path):
    """Folders written by the port are read by the reference and the other
    way round, bf16 (uint16 bits under "bfloat16") and a scalar included."""
    tree = _offload_tree()
    bf16 = torch.from_numpy(tree["c/bf16"]).to(torch.bfloat16)
    port = {**{k: torch.from_numpy(v) for k, v in tree.items() if k != "c/bf16"}, "c/bf16": bf16}
    jtree = {**tree, "c/bf16": np.asarray(jnp.asarray(tree["c/bf16"], jnp.bfloat16))}
    offload.offload_state_dict(str(tmp_path / "port"), port)
    joffload.offload_state_dict(str(tmp_path / "ref"), jtree)
    assert offload.load_offload_index(str(tmp_path / "port")) == joffload.load_offload_index(
        str(tmp_path / "ref"))
    for name in tree:
        assert (tmp_path / "port" / f"{name.replace('/', '--')}.dat").read_bytes() == (
            tmp_path / "ref" / f"{name.replace('/', '--')}.dat").read_bytes()
    by_ref = joffload.OffloadedWeightsLoader(save_folder=str(tmp_path / "port"))
    by_port = offload.OffloadedWeightsLoader(save_folder=str(tmp_path / "ref"))
    for name in tree:
        got, want = by_port[name], port[name]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
        ref_read = by_ref[name]
        assert ref_read.shape == tuple(want.shape)
        np.testing.assert_array_equal(np.asarray(ref_read, np.float64),
                                      want.double().numpy())
    assert str(by_ref["c/bf16"].dtype) == "bfloat16"


def test_offloaded_bytes_and_streamed_pair(tiny_gpt2, tmp_path):
    """What each block streams per call, and the two consecutive blocks
    that stream the most (the peak-memory bound's streamed share)."""
    cfg, _, sd, _, _ = tiny_gpt2
    sizes = modeling.compute_module_sizes(sd)
    dmap = {"embed": "device", "block_0": "cpu", "block_1/attn": "disk", "block_1/ln_1": "device",
            "block_1/ln_2": "cpu", "block_1/mlp": "cpu", "head": "disk"}
    bw = bm.dispatch_model(gpt2.gpt2_blockwise(cfg), dmap, sd, offload_dir=str(tmp_path),
                           device="cpu")
    blocks = bw.offloaded_bytes()
    b1 = sizes["block_1"] - sizes["block_1/ln_1"]
    assert blocks == [("embed", 0, 0), ("block_0", sizes["block_0"], 12), ("block_1", b1, 10),
                      ("head", sizes["head"], 3)]
    assert bw.streamed_pair() == (sizes["block_0"] + b1, 22)
