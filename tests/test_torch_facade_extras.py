"""The rest of the port's one-process facade, on the CPU: ``autocast``,
``profile``, ``save``, the triggers, ``split_between_processes``,
``verify_device_map`` refused by ``prepare``, the kwargs handlers of
`utils.dataclasses` (their fields are the reference's), the one-process
properties, the trackers' ``log_images`` / ``log_table``, and the
environment and `utils.other` helpers, each beside the reference's where
both packages can run it."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from accelerate_tpu.tracking import _image_to_uint8_hwc as jax_image_to_uint8_hwc  # noqa: E402
from accelerate_tpu.utils import dataclasses as jax_dataclasses  # noqa: E402
from accelerate_tpu.utils import environment as jax_environment  # noqa: E402
from accelerate_tpu.utils import other as jax_other  # noqa: E402
from accelerate_tpu_torch import tracking  # noqa: E402
from accelerate_tpu_torch.accelerator import Accelerator, ProjectConfiguration  # noqa: E402
from accelerate_tpu_torch.utils import dataclasses as dc  # noqa: E402
from accelerate_tpu_torch.utils import environment, other  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _linear(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Linear(8, 4)


class _Cast(torch.nn.Linear):
    """A linear layer that computes in its weight's dtype, as the port's
    models do."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


def test_autocast_disabled_runs_the_fp32_masters():
    acc = Accelerator(mixed_precision="bf16", device="cpu")
    torch.manual_seed(0)
    model = acc.prepare(_Cast(8, 4))
    x = torch.randn(3, 8)
    want = model.module(x)
    assert not torch.equal(model(x), want)  # bf16 copies of the weights
    with acc.autocast(dc.AutocastKwargs(enabled=False)):
        assert torch.equal(model(x), want)
    assert not torch.equal(model(x), want)  # the policy is back after the block
    with acc.autocast():  # no handler: enabled
        assert not torch.equal(model(x), want)
    acc2 = Accelerator(mixed_precision="bf16", device="cpu",
                       kwargs_handlers=[dc.AutocastKwargs(enabled=False)])
    model2 = acc2.prepare(_Cast(8, 4))
    with acc2.autocast():  # the handler of kwargs_handlers
        assert torch.equal(model2(x), model2.module(x))


def test_profile_writes_a_chrome_trace(tmp_path):
    acc = Accelerator(device="cpu", kwargs_handlers=[
        dc.ProfileKwargs(output_trace_dir=str(tmp_path / "handler"))])
    model = acc.prepare(_linear())
    with acc.profile() as prof:
        model(torch.randn(3, 8)).sum()
    (trace,) = (tmp_path / "handler").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("addmm" in ev.get("name", "") for ev in events)
    assert prof.key_averages()  # the torch profiler is what the block gets
    with acc.profile(log_dir=str(tmp_path / "explicit")):
        model(torch.randn(3, 8))
    assert list((tmp_path / "explicit").glob("trace_*.json"))


def test_save_round_trips_and_the_reference_reads_safetensors(tmp_path):
    acc = Accelerator(device="cpu")
    obj = {"w": torch.arange(6.0).reshape(2, 3), "nested": {"b": torch.ones(2)}}
    acc.save(obj, tmp_path / "obj.pt")
    back = other.load(tmp_path / "obj.pt")
    assert torch.equal(back["w"], obj["w"]) and torch.equal(back["nested"]["b"], obj["nested"]["b"])
    acc.save(obj, str(tmp_path / "obj.bin"), safe_serialization=True)  # sniffed, not named
    for loaded in (other.load(tmp_path / "obj.bin"), jax_other.load(str(tmp_path / "obj.bin"))):
        np.testing.assert_array_equal(np.asarray(loaded["w"]), obj["w"].numpy())
        np.testing.assert_array_equal(np.asarray(loaded["nested"]["b"]), np.ones(2))


def test_trigger_is_seen_once():
    acc = Accelerator(device="cpu")
    assert not acc.check_trigger()
    acc.set_trigger()
    assert acc.check_trigger()
    assert not acc.check_trigger()


def test_split_between_processes_at_one_process_is_everything():
    acc = Accelerator(device="cpu")
    for inputs in ([1, 2, 3], {"a": [1, 2], "b": [3, 4]}, np.arange(5)):
        with acc.split_between_processes(inputs, apply_padding=True) as share:
            assert share is inputs


def test_prepare_refuses_a_multi_entry_device_map():
    acc = Accelerator(device="cpu")
    model = _linear()
    model.device_map = {"0": "cpu", "1": "disk"}
    assert acc.verify_device_map(model)
    with pytest.raises(ValueError, match="multi-entry device map"):
        acc.prepare(model)
    model.device_map = {"": "cpu"}
    assert not acc.verify_device_map(model)
    acc.prepare(model)


def test_handlers_keep_the_reference_s_fields():
    for name in ("GradScalerKwargs", "DataLoaderConfiguration", "ProfileKwargs",
                 "CompilationConfig", "FP8RecipeKwargs", "AutocastKwargs"):
        mine = [(f.name, f.default) for f in dataclasses.fields(getattr(dc, name))]
        theirs = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_dataclasses, name))]
        assert mine == theirs, name
        assert getattr(dc, name)().to_dict() == getattr(jax_dataclasses, name)().to_dict()


def test_kwargs_handlers_reach_the_accelerator():
    acc = Accelerator(mixed_precision="fp16", device="cpu",
                      kwargs_handlers=[dc.GradScalerKwargs(init_scale=1024.0, growth_interval=7)])
    assert acc.scaler.init_scale == 1024.0 and acc.scaler.growth_interval == 7
    off = Accelerator(mixed_precision="fp16", device="cpu",
                      kwargs_handlers=[dc.GradScalerKwargs(enabled=False)])
    assert off.scaler is None
    recipe = dc.FP8RecipeKwargs(margin=2)
    assert Accelerator(device="cpu", kwargs_handlers=[recipe]).fp8_recipe_handler is recipe
    with pytest.raises(ValueError, match="Duplicate"):
        Accelerator(device="cpu", kwargs_handlers=[dc.AutocastKwargs(), dc.AutocastKwargs()])
    with pytest.raises(ValueError, match="dataloader_config="):
        Accelerator(device="cpu", kwargs_handlers=[dc.DataLoaderConfiguration()])
    with pytest.raises(ValueError, match="Unsupported"):
        Accelerator(device="cpu", kwargs_handlers=[object()])
    for plugin in (dc.FullyShardedDataParallelPlugin, dc.DeepSpeedPlugin, dc.MegatronLMPlugin):
        with pytest.raises(NotImplementedError, match="item 21.3"):
            plugin()


def test_data_parallel_handlers_are_built_and_read():
    """`InitProcessGroupKwargs` and `DistributedDataParallelKwargs` keep the
    reference's fields and defaults, and the latter gives the comm hook's
    config (`to_comm_hook_config`), which the accelerator takes."""
    for name in ("InitProcessGroupKwargs", "DistributedDataParallelKwargs"):
        mine = [(f.name, f.default) for f in dataclasses.fields(getattr(dc, name))]
        theirs = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_dataclasses, name))]
        assert mine[:len(theirs)] == theirs, name
    assert dc.DistributedDataParallelKwargs().to_comm_hook_config() is None
    cfg = dc.DistributedDataParallelKwargs(comm_hook="power_sgd", matrix_approximation_rank=2,
                                           start_powerSGD_iter=5).to_comm_hook_config()
    want = jax_dataclasses.DistributedDataParallelKwargs(
        comm_hook="power_sgd", matrix_approximation_rank=2,
        start_powerSGD_iter=5).to_comm_hook_config()
    assert (cfg.comm_hook, cfg.matrix_approximation_rank, cfg.start_powerSGD_iter,
            cfg.min_compression_elems, cfg.warmup_updates) == \
        (want.comm_hook, want.matrix_approximation_rank, want.start_powerSGD_iter,
         want.min_compression_elems, want.warmup_updates)
    wrapped = dc.DistributedDataParallelKwargs(
        comm_hook="batched_power_sgd", comm_wrapper="bf16",
        comm_state_option={"min_compression_elems": 64}).to_comm_hook_config()
    assert (wrapped.wrapper, wrapped.min_compression_elems, wrapped.is_powersgd) == \
        ("bf16", 64, True)
    assert dc.DistributedDataParallelKwargs(comm_hook="bf16").to_comm_hook_config().comm_hook == \
        "bf16"
    init = dc.InitProcessGroupKwargs(timeout_seconds=60, backend="gloo")
    acc = Accelerator(device="cpu", kwargs_handlers=[init, dc.DistributedDataParallelKwargs(
        comm_hook="fp16")])
    assert acc.init_handler is init and acc.ddp_handler.comm_hook == "fp16"
    assert acc.num_processes == 1  # no launcher environment: no process group


def test_one_process_properties(tmp_path):
    acc = Accelerator(device="cpu", dataloader_config=dc.DataLoaderConfiguration(
        use_seedable_sampler=False, use_stateful_dataloader=False),
        project_config=ProjectConfiguration(project_dir=str(tmp_path),
                                            automatic_checkpoint_naming=True))
    assert (acc.distributed_type, acc.num_devices, acc.non_blocking) == ("NO", 1, True)
    assert not acc.use_seedable_sampler and not acc.use_stateful_dataloader
    defaults = Accelerator(device="cpu")
    assert defaults.use_seedable_sampler and defaults.use_stateful_dataloader
    model = acc.prepare(_linear())
    acc.prepare(torch.optim.SGD(model.parameters(), lr=0.1))
    assert acc.save_iteration == 0
    acc.save_state()
    assert acc.save_iteration == 1
    acc.gradient_accumulation_steps = 3
    assert acc.gradient_state.num_steps == 3
    assert acc.unwrap_model(model) is model.module


def test_jsonl_images_and_table_as_the_reference_writes_them(tmp_path):
    t = tracking.JSONLTracker("run", logging_dir=str(tmp_path))
    t.log_images({"viz/heat": torch.full((4, 4), 0.25)}, step=7)
    t.log_images({"a/b": np.zeros((2, 2), np.float32), "a_b": np.ones((2, 2), np.float32)})
    t.log_images({"batch": np.zeros((2, 3, 3, 3), np.float32)}, step=8)
    t.log_table("results", columns=["metric", "value"], data=[["acc", 0.9]], step=3)
    t.log_table("defaults", data=[[1, 2]])
    t.finish()
    rows = [json.loads(line) for line in open(tmp_path / "run.metrics.jsonl")]
    images = [r for r in rows if "_images" in r]
    assert images[0]["_step"] == 7
    saved = np.load(images[0]["_images"]["viz/heat"])
    assert saved.dtype == np.uint8 and saved.shape == (4, 4, 1) and saved.max() == 63
    paths = list(images[1]["_images"].values())
    assert len(set(paths)) == 2 and all(os.path.exists(p) for p in paths)
    assert sorted(images[2]["_images"]) == ["batch_0", "batch_1"]
    tables = [r["_table"] for r in rows if "_table" in r]
    assert tables[0] == {"name": "results", "columns": ["metric", "value"], "rows": [["acc", "0.9"]]}
    assert tables[1]["columns"] == ["col_0", "col_1"]
    for img in (np.full((4, 5, 3), 0.5, np.float32), np.zeros((3, 8, 9), np.uint8),
                np.array([[[0], [128], [255]]], dtype=np.int32), np.zeros((4, 5), np.float32)):
        np.testing.assert_array_equal(tracking._image_to_uint8_hwc(img),
                                      jax_image_to_uint8_hwc(img))
    with pytest.raises(ValueError, match="log_table needs"):
        tracking._table_rows(None, None, None)


def test_base_tracker_reports_unsupported():
    class Bare(tracking.GeneralTracker):
        name = "bare"

    with pytest.raises(NotImplementedError, match="does not support log_images"):
        Bare().log_images({})
    with pytest.raises(NotImplementedError, match="does not support log_table"):
        Bare().log_table("t", data=[[1]])


def test_environment_helpers_match_the_reference(monkeypatch):
    for value in ("y", "YES", "t", "true", "On", "1", "n", "no", "F", "false", "off", "0"):
        assert environment.str_to_bool(value) == jax_environment.str_to_bool(value)
    with pytest.raises(ValueError):
        environment.str_to_bool("maybe")
    monkeypatch.setenv("PORT_FLAG", "yes")
    monkeypatch.setenv("PORT_INT", "  ")
    monkeypatch.setenv("PORT_B", "7")
    for pkg in (environment, jax_environment):
        assert pkg.parse_flag_from_env("PORT_FLAG") is True
        assert pkg.parse_flag_from_env("PORT_UNSET", default=True) is True
        assert pkg.parse_choice_from_env("PORT_UNSET", "bf16") == "bf16"
        assert pkg.parse_int_from_env("PORT_INT", 5) == 5
        assert pkg.get_int_from_env(["PORT_A", "PORT_B"], 1) == 7
    monkeypatch.setenv("PORT_FLAG", "perhaps")
    with pytest.raises(ValueError, match="PORT_FLAG"):
        environment.parse_flag_from_env("PORT_FLAG")
    monkeypatch.delenv("PORT_PATCHED", raising=False)
    with environment.patch_environment(port_patched=3, port_b="x"):
        assert os.environ["PORT_PATCHED"] == "3" and os.environ["PORT_B"] == "x"
    assert "PORT_PATCHED" not in os.environ and os.environ["PORT_B"] == "7"
    with environment.clear_environment():
        assert "PORT_B" not in os.environ
    assert os.environ["PORT_B"] == "7"


def test_other_helpers_match_the_reference():
    for size in (0, 1023, 1536, 5 * 1024**3, 3 * 1024**4):
        assert other.convert_bytes(size) == jax_other.convert_bytes(size)
    for obj in (Accelerator, other.save, 3):
        assert other.get_pretty_name(obj) == jax_other.get_pretty_name(obj)
