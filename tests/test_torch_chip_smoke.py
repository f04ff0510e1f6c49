"""`chip_smoke.py`'s reading of a ptxas log: the flash forward kernels' and
the bf16 dQ, dK/dV and fused-CE forward, dH and dW kernels' registers,
spills and static shared memory, which its build phase prints and holds to
zero spills; its split of profiled kernel names into the fused-CE forward,
dH and dW; and its serving bookkeeping: kernel launches counted through
decode graph replays, the fields of a serving line, the admission counter
through prefix-cached admissions, phase 21's prompts and its verify
counts; the head_dim 192 and 256 kernels' ptxas entries and the run-time
head_dim body's (d 0); the reliability phase's serving child (what it
imports, the engine modes it serves); and the data-parallel phase's child
and its launch through the port's launcher. Runs on the CPU against a log
in ptxas's format and a CPU engine."""

import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import torch
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]

LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_PfNS_4MaskILb1ELb1EEENS_7FwdMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_PfNS_4MaskILb1ELb1EEENS_7FwdMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_dkv_kernelI13__nv_bfloat16Li128ELb0EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_NS_4MaskIXT1_ELb0EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_dkv_kernelI13__nv_bfloat16Li128ELb0EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_NS_4MaskIXT1_ELb0EEE
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 1024 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI13__nv_bfloat16Li128ELb1EEEvPKT_S4_S4_PS2_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI13__nv_bfloat16Li128ELb1EEEvPKT_S4_S4_PS2_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsE
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 96 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897915flash_dq_kernelI13__nv_bfloat16Li64ELb1EEEvPKT_S4_S4_S4_PKfS6_PS2_NS_4MaskIXT1_ELb0EEENS_6DqMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897915flash_dq_kernelI13__nv_bfloat16Li64ELb1EEEvPKT_S4_S4_S4_PKfS6_PS2_NS_4MaskIXT1_ELb0EEENS_6DqMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897920flash_band_dq_kernelIfLi128EEEvPKT_S3_S3_S3_PKfS5_PS1_NS_4MaskILb1ELb1EEENS_6DqMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897920flash_band_dq_kernelIfLi128EEEvPKT_S3_S3_S3_PKfS5_PS1_NS_4MaskILb1ELb1EEENS_6DqMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897920flash_band_dq_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_NS_4MaskILb1ELb1EEENS_6DqMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897920flash_band_dq_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_NS_4MaskILb1ELb1EEENS_6DqMapsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 16 bytes smem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_bwd_kernelIfLb0EEEvPKT_S3_PKiPKfS7_S7_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_bwd_kernelIfLb0EEEvPKT_S3_PKiPKfS7_S7_PS1_iiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_bwd_kernelI13__nv_bfloat16Lb0ELi3EEEvNS_9BwdParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_bwd_kernelI13__nv_bfloat16Lb0ELi3EEEvNS_9BwdParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelI13__nv_bfloat16EEvPKT_S3_PKiPfS6_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelI13__nv_bfloat16EEvPKT_S3_PKiPfS6_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_bwd_kernelI13__nv_bfloat16Lb1ELi4EEEvNS_9BwdParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_bwd_kernelI13__nv_bfloat16Lb1ELi4EEEvNS_9BwdParamsE
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 32 bytes smem
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_forward_resources_reads_only_the_forward_kernels():
    got = _chip_smoke().forward_resources(LOG)
    assert got == [
        {"kernel": "flash_band_fwd_kernel", "dtype": "float32", "d": 64, "registers": 80,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 0},
        {"kernel": "flash_fwd_kernel", "dtype": "bfloat16", "d": 128, "causal": True,
         "registers": 168, "spill_store_bytes": 16, "spill_load_bytes": 12,
         "static_smem_bytes": 96},
    ]


def test_forward_resources_of_an_empty_log():
    assert _chip_smoke().forward_resources("") == []


def test_dkv_resources_reads_only_the_bf16_dkv_kernels():
    got = _chip_smoke().dkv_resources(LOG)
    assert got == [
        {"kernel": "flash_dkv_kernel", "dtype": "bfloat16", "d": 128, "causal": False,
         "registers": 255, "spill_store_bytes": 8, "spill_load_bytes": 8,
         "static_smem_bytes": 1024},
    ]


def test_dq_resources_reads_only_the_bf16_dq_kernels():
    got = _chip_smoke().dq_resources(LOG)
    assert got == [
        {"kernel": "flash_dq_kernel", "dtype": "bfloat16", "d": 64, "causal": True,
         "registers": 168, "spill_store_bytes": 0, "spill_load_bytes": 0,
         "static_smem_bytes": 0},
        {"kernel": "flash_band_dq_kernel", "dtype": "bfloat16", "d": 128, "registers": 168,
         "spill_store_bytes": 4, "spill_load_bytes": 4, "static_smem_bytes": 16},
    ]


FUSED_FWD_LOG = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelI13__nv_bfloat16Li128EEEvNS_9FwdParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelI13__nv_bfloat16Li128EEEvNS_9FwdParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelIfEEvPKT_S3_PKiPfS6_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelIfEEvPKT_S3_PKiPfS6_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
"""


def test_fused_ce_fwd_resources_reads_only_the_bf16_sm90_forward():
    """The bf16 forward (``fused_ce_fwd_kernel<bf16, 128>(FwdParams)``), not
    the fp32 one, nor any backward kernel."""
    got = _chip_smoke().fused_ce_fwd_resources(LOG + FUSED_FWD_LOG)
    assert got == [
        {"kernel": "fused_ce_fwd_kernel", "dtype": "bfloat16", "vocab_tile": 128, "registers": 168,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 0},
    ]
    assert _chip_smoke().fused_ce_fwd_resources(LOG) == []


def test_fused_ce_bwd_resources_reads_only_the_bf16_bwd_kernels():
    got = _chip_smoke().fused_ce_bwd_resources(LOG)
    assert _chip_smoke().fused_ce_bwd_resources(LOG + FUSED_FWD_LOG) == got
    assert got == [
        {"kernel": "fused_ce_bwd_kernel", "dtype": "bfloat16", "dw": False,
         "chunks_per_warpgroup": 3, "registers": 168,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 0},
        {"kernel": "fused_ce_bwd_kernel", "dtype": "bfloat16", "dw": True,
         "chunks_per_warpgroup": 4, "registers": 168,
         "spill_store_bytes": 16, "spill_load_bytes": 12, "static_smem_bytes": 32},
    ]


def test_kernel_resources_takes_the_name_pattern_and_its_fields():
    got = _chip_smoke().kernel_resources(LOG, r"fused_ce_(?:fwd|bwd)_kernel", ("dw",))
    assert [(k["dtype"], k.get("dw"), k["spill_store_bytes"]) for k in got] == [
        ("float32", False, 4), ("bfloat16", False, 0), ("bfloat16", True, 16)]
    assert _chip_smoke().kernel_resources("", r"fused_ce_bwd_kernel", ("dw",)) == []


def test_fused_ce_part_splits_forward_dh_and_dw():
    part = _chip_smoke().fused_ce_part
    ns = "void (anonymous namespace)::"
    assert part(ns + "fused_ce_fwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)") == "forward"
    assert part(ns + "fused_ce_fwd_kernel<__nv_bfloat16, 128>("
                "(anonymous namespace)::FwdParams)") == "forward"
    assert part(ns + "fused_ce_bwd_kernel<__nv_bfloat16, false, 3>("
                "(anonymous namespace)::BwdParams)") == "dH"
    assert part(ns + "fused_ce_bwd_kernel<__nv_bfloat16, true, 3>("
                "(anonymous namespace)::BwdParams)") == "dW"
    assert part(ns + "fused_ce_bwd_kernel<float, true>(float const*, int)") == "dW"
    assert part(ns + "flash_dq_kernel<__nv_bfloat16, 64, true>(int)") is None


SERVING_LOG = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__74e36811_15_paged_decode_cu_ad584a0a19paged_decode_kernelI13__nv_bfloat16S1_Lb0ELi64ELi1ELi16EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__74e36811_15_paged_decode_cu_ad584a0a19paged_decode_kernelI13__nv_bfloat16S1_Lb0ELi64ELi1ELi16EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__74e36811_15_paged_decode_cu_ad584a0a19paged_decode_kernelIfaLb1ELi0ELi0ELi4EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__74e36811_15_paged_decode_cu_ad584a0a19paged_decode_kernelIfaLb1ELi0ELi0ELi4EEEvNS_6ParamsE
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__8eec4b19_13_nf4_matmul_cu_75e1ed4317nf4_matmul_kernelI13__nv_bfloat16Li16EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__8eec4b19_13_nf4_matmul_cu_75e1ed4317nf4_matmul_kernelI13__nv_bfloat16Li16EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 240 registers, used 1 barriers, 64 bytes smem
"""


def test_serving_kernel_resources_name_each_instance():
    """The paged-decode kernels' template arguments (D and G 0: the general
    body) and the nf4 kernels' rows, each with its registers and spills."""
    cs = _chip_smoke()
    assert cs.paged_decode_resources(SERVING_LOG) == [
        {"q": "13__nv_bfloat16", "pool": "S1_", "quant": 0, "d": 64, "groups": 1, "piece_bytes": 16,
         "registers": 56, "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 0},
        {"q": "f", "pool": "a", "quant": 1, "d": 0, "groups": 0, "piece_bytes": 4,
         "registers": 64, "spill_store_bytes": 8, "spill_load_bytes": 4, "static_smem_bytes": 0},
    ]
    assert cs.nf4_resources(SERVING_LOG) == [
        {"dtype": "13__nv_bfloat16", "rows": 16, "registers": 240, "spill_store_bytes": 0,
         "spill_load_bytes": 0, "static_smem_bytes": 64},
    ]
    assert cs.paged_decode_resources(LOG) == [] and cs.nf4_resources(LOG) == []


def test_replay_launches_adds_each_replays_captured_launches():
    from accelerate_tpu_torch.serving import ServingMetrics

    engine = SimpleNamespace(graph_launches={"paged_decode_attention": 48, "nf4_matmul": 192},
                             metrics=ServingMetrics())
    engine.metrics.decode_dispatches.inc(5)
    replay_launches = _chip_smoke().replay_launches
    assert replay_launches(engine, "paged_decode_attention", 0) == 5 * 48
    assert replay_launches(engine, "nf4_matmul", 96) == 96 + 5 * 192  # prefills launch eagerly
    assert replay_launches(engine, "flash_attention_fwd", 7) == 7  # never in the graph
    engine.graph_launches = {}  # an engine on the CPU: no graph
    assert replay_launches(engine, "paged_decode_attention", 3) == 3


def test_serving_line_reads_the_engine_run():
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import Request, SamplingParams, ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    engine = ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16,),
                           pipeline_depth=2, tokens_per_sync=4, paged_kv=True,
                           paged_attention="fused")
    outs = engine.run([Request(prompt=[3, 4, 5], params=SamplingParams(max_new_tokens=9))
                       for _ in range(3)])
    line = _chip_smoke().serving_line(engine, outs, 2.0, 123, 4567, "H100, 700 W", extra=1)
    m = engine.metrics
    assert line["phase"] == "bf16_serving" and line["card"] == "H100, 700 W"
    assert (line["pipeline_depth"], line["tokens_per_sync"], line["requests"]) == (2, 4, 3)
    assert line["generated_tokens"] == 27 and line["tokens_per_s"] == 13.5
    assert line["decode_replays"] == m.decode_dispatches.value > 0
    assert line["decode_steps"] == 4 * line["decode_replays"]
    assert (line["kernel_launches"], line["peak_mem_bytes"], line["extra"]) == (123, 4567, 1)
    assert line["host_blocked_p50_s"] == m.host_blocked_s.quantile(0.5) >= 0
    for key in ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s"):
        assert line[key] >= 0
    assert line["itl_p50_s"] <= line["itl_p99_s"]
    assert list(line)[-1] == "card"


def test_top2_margin_is_the_smallest_row_gap():
    logits = torch.tensor([[0.0, 3.0, 2.5], [1.0, 1.25, -4.0]])
    assert _chip_smoke().top2_margin(torch, logits) == 0.25


def test_synthetic_checkpoint_is_the_reference_tools_layout(tmp_path):
    """The big-model phase's checkpoint: zeros in fp16, the reference's
    names and ``[in, out]`` kernels, loadable into the port's Llama through
    `params_from_jax`; the parameter count is the model's."""
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
    from accelerate_tpu_torch.utils.safetensors_io import (
        load_checkpoint_in_model,
        load_safetensors_checkpoint,
    )

    cfg = LlamaConfig.tiny(num_kv_heads=2)
    n = _chip_smoke().synthetic_checkpoint(torch, cfg, tmp_path)
    flat = load_safetensors_checkpoint(tmp_path)
    assert all(t.dtype == torch.float16 and not t.any() for t in flat.values())
    assert tuple(flat["layer_1.attn.k_proj.kernel"].shape) == (64, 32)
    assert tuple(flat["layer_0.mlp.down_proj.kernel"].shape) == (128, 64)
    model = LlamaForCausalLM(cfg, device="cpu")
    assert n == sum(p.numel() for p in model.parameters())
    load_checkpoint_in_model(model, tmp_path, mapper=params_from_jax)
    assert not any(p.any() for p in model.parameters())


WIDE_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI13__nv_bfloat16Li256ELb1EEEvPKT_S4_S4_PS2_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI13__nv_bfloat16Li256ELb1EEEvPKT_S4_S4_PS2_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelIfLi192EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelIfLi192EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""


def test_resources_read_the_wide_head_dims():
    """The head_dim 192 and 256 instances (the scalar bodies, bf16 ones
    included) parse with their head_dim, so the build phase holds them to
    zero spills too."""
    cs = _chip_smoke()
    assert cs.forward_resources(WIDE_LOG) == [
        {"kernel": "flash_fwd_kernel", "dtype": "bfloat16", "d": 256, "causal": True,
         "registers": 79, "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 0},
    ]
    assert [(k["kernel"], k["dtype"], k["d"]) for k in cs.kernel_resources(
        WIDE_LOG, r"flash_(?:band_)?dkv_kernel", cs.FLASH_FIELDS)] == [
        ("flash_band_dkv_kernel", "float32", 192)]


def _tiny_engine(**kw):
    from accelerate_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from accelerate_tpu_torch.serving import ServingEngine

    model = GPT2LMHead(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    return ServingEngine(model, device="cpu", max_concurrency=2, prompt_buckets=(16, 64), **kw)


def test_count_admissions_counts_cached_admissions_too():
    """Phase 20's admission share: the wrapper passes a cached admission's
    prefix matches through and counts each seated group once."""
    from accelerate_tpu_torch.serving import Request, SamplingParams

    engine = _tiny_engine(prefix_cache=True, admit_batch=1)
    counter = _chip_smoke().count_admissions(engine)
    prefix = list(range(40))
    engine.run([Request(prompt=prefix + [100 + i], params=SamplingParams(max_new_tokens=3))
                for i in range(5)])
    m = engine.metrics
    assert counter[0] == m.admit_batch_size.count == 5 and counter[1] > 0
    assert m.prefix_hits.value == 3 and m.prefix_tokens_reused.value == 3 * 32


def test_spec_prompts_repeat_one_pattern():
    import numpy as np

    prompts = _chip_smoke().spec_prompts(np, 0)
    assert len(prompts) == 32 and all(64 <= len(p) <= 256 for p in prompts)
    pattern = prompts[0][:32]
    assert all(p == (pattern * 8)[:len(p)] for p in prompts)
    assert all(0 <= t < 50257 for t in pattern)


def test_serving_line_carries_the_verify_counts():
    """A spec engine's run through `serving_line`, as phase 21 prints it:
    every token after a request's first came from a verify dispatch."""
    from accelerate_tpu_torch.serving import Request, SamplingParams

    engine = _tiny_engine(speculation=3)
    outs = engine.run([Request(prompt=[5, 6, 7] * 4, params=SamplingParams(max_new_tokens=9))
                       for _ in range(3)])
    m = engine.metrics
    line = _chip_smoke().serving_line(engine, outs, 1.0, 0, 0, "H100, 700 W",
                                      phase="bfloat16_spec_serving",
                                      spec_tokens=m.spec_tokens.value)
    assert line["phase"] == "bfloat16_spec_serving" and line["generated_tokens"] == 27
    assert line["spec_tokens"] == 27 - 3 and line["decode_replays"] == m.spec_forwards.value


RUNTIME_D_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI13__nv_bfloat16Li0ELb1EEEvPKT_S4_S4_PS2_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsENS_4WideE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI13__nv_bfloat16Li0ELb1EEEvPKT_S4_S4_PS2_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsENS_4WideE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 104 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelIfLi0EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsENS_4WideE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelIfLi0EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsENS_4WideE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""


def test_resources_read_the_run_time_head_dim_kernels():
    """The run-time head_dim body's instances (template D 0, every head_dim
    above 256) parse with d 0, so the build phase holds them to zero spills
    too."""
    cs = _chip_smoke()
    assert cs.forward_resources(RUNTIME_D_LOG) == [
        {"kernel": "flash_fwd_kernel", "dtype": "bfloat16", "d": 0, "causal": True,
         "registers": 104, "spill_store_bytes": 0, "spill_load_bytes": 0,
         "static_smem_bytes": 0},
    ]
    assert [(k["kernel"], k["dtype"], k["d"]) for k in cs.kernel_resources(
        RUNTIME_D_LOG, r"flash_(?:band_)?dkv_kernel", cs.FLASH_FIELDS)] == [
        ("flash_band_dkv_kernel", "float32", 0)]


def test_reliability_child_imports_only_the_port_and_serves_both_modes():
    """Phase 23's serving child is a script of its own: it imports torch
    and the port (never JAX or the JAX package), and builds one engine per
    mode: the paged fused engine and the slot engine."""
    import ast

    cs = _chip_smoke()
    roots = set()
    for node in ast.walk(ast.parse(cs.RELIABILITY_CHILD)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"json", "sys", "time", "torch", "accelerate_tpu_torch"}
    assert cs.RELIABILITY_MODES == {"paged_fused": {"paged_kv": True, "paged_attention": "fused"},
                                    "slot": {}}


FP16_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI6__halfLi64ELb1EEEvPKT_S3_S3_PS1_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897916flash_fwd_kernelI6__halfLi64ELb1EEEvPKT_S3_S3_PS1_PfNS_4MaskIXT1_ELb0EEENS_7FwdMapsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelI6__halfLi0EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a0289467_18_flash_attention_cu_2c13897921flash_band_dkv_kernelI6__halfLi0EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_NS_4MaskILb1ELb1EEENS_7DkvMapsE
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelI6__halfEEvPKT_S3_PKiPfS6_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__d61153fb_11_fused_ce_cu_935e5b8619fused_ce_fwd_kernelI6__halfEEvPKT_S3_PKiPfS6_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
""" + LOG


def test_fp16_instances_are_read_and_held_to_zero_spills():
    """The fp16 instances (scalar bodies) of the flash and fused-CE kernels:
    every one by name, the scalar fused-CE forward (one template argument)
    too, and none of the bf16 or fp32 ones; `kernel_resources` names their
    type."""
    cs = _chip_smoke()
    found = cs.fp16_resources(FP16_LOG)
    assert [k["kernel"] for k in found] == ["flash_fwd_kernel", "flash_band_dkv_kernel",
                                            "fused_ce_fwd_kernel"]
    assert [k["spill_store_bytes"] for k in found] == [0, 4, 0]
    assert cs.forward_resources(FP16_LOG)[0] == {
        "kernel": "flash_fwd_kernel", "dtype": "float16", "d": 64, "causal": True,
        "registers": 122, "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 0}
    assert all(k["dtype"] == "bfloat16" for k in cs.dkv_resources(FP16_LOG))


def test_fp8_peak_and_the_precision_runs():
    cs = _chip_smoke()
    # the data sheets' dense rates: fp8 twice bf16's (1979 and 989 TFLOP/s)
    assert cs.fp8_peak("NVIDIA H100 80GB HBM3") == 1979e12
    assert cs.fp8_peak("NVIDIA H100 PCIe") > 1.99 * cs.bf16_peak("NVIDIA H100 PCIe")
    assert [r[0] for r in cs.PRECISION_RUNS] == ["bf16", "fp8_model", "fp8_all",
                                                 "fp8_all_remat_dots", "fp16"]


def test_synthetic_hf_checkpoints_hold_one_set_of_weights(tmp_path):
    """Phase 19's HF variant: seeded non-zero fp16 values, once under
    Hugging Face's names and layout and once under the reference's; each
    loads into the port's Llama through its map to the same state, and the
    parameter count is the model's."""
    from accelerate_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        params_from_hf_llama,
        params_from_jax,
    )
    from accelerate_tpu_torch.utils.safetensors_io import (
        load_checkpoint_in_model,
        load_safetensors_checkpoint,
    )

    cfg = LlamaConfig.tiny(num_kv_heads=2)
    n = _chip_smoke().synthetic_hf_checkpoints(torch, cfg, tmp_path / "hf", tmp_path / "ref", 0)
    flat = load_safetensors_checkpoint(tmp_path / "hf")
    assert all(t.dtype == torch.float16 and t.any() for t in flat.values())
    assert tuple(flat["model.layers.1.self_attn.k_proj.weight"].shape) == (32, 64)
    models = []
    for sub, mapper in (("hf", lambda f: params_from_hf_llama(f, cfg)), ("ref", params_from_jax)):
        model = LlamaForCausalLM(cfg, device="cpu")
        load_checkpoint_in_model(model, tmp_path / sub, mapper=mapper)
        models.append(model.state_dict())
    assert n == sum(p.numel() for p in LlamaForCausalLM(cfg, device="cpu").parameters())
    assert all(torch.equal(models[0][k], models[1][k]) for k in models[0])


def test_build_line_names_a_spilling_kernel_and_its_type():
    cs = _chip_smoke()
    spilling = [f"{m.group(1)}<{cs._MANGLED_DTYPES[m.group(2)]}>"
                for m, res in cs.ptxas_entries(FP16_LOG, cs._KERNEL_NAME)
                if res["spill_store_bytes"]]
    assert spilling == ["flash_band_dkv_kernel<float16>", "flash_dkv_kernel<bfloat16>",
                        "flash_fwd_kernel<bfloat16>", "flash_band_dq_kernel<bfloat16>",
                        "fused_ce_bwd_kernel<float32>", "fused_ce_bwd_kernel<bfloat16>"]
    # an fp8 GEMM's kernel counts as one in the training profiles
    assert next(c for c, pattern in cs.TRAIN_KERNEL_CATEGORIES
                if re.search(pattern, "sm90_xmma_gemm_e4m3e4m3_bf16", re.IGNORECASE)) == "fp8 GEMMs"


def test_big_model_phase_accounting():
    """Phase 30's arithmetic: Mixtral-8x7B's parameters (46.7 B, 1.451 B a
    layer), its train FLOPs per token, active (top-2) and executed (every
    expert's capacity slots and the dispatch and combine products), and the
    PCIe 5.0 x16 rate."""
    cs = _chip_smoke()
    from accelerate_tpu_torch.models.mixtral import MixtralConfig

    counts = cs.mixtral_param_counts(MixtralConfig())
    assert counts["layer"] == 1_451_270_144 and counts["experts"] == 8 * 3 * 4096 * 14336
    assert counts["total"] == 46_702_792_704  # 93.4 GB in bf16
    flops = cs.mixtral_train_flops_per_token(MixtralConfig(num_layers=2), 4096)
    assert flops["capacity"] == 2048
    e, f = 4096, 14336
    # capacity 2.0 runs 4 experts' worth of slots a token where 2 are used,
    # plus the two one-hot products, 2 T E C e each: forward, then the
    # dispatch's once and the combine's twice in the backward
    assert flops["executed"] - flops["active"] == 2 * (6 * 2 * 3 * e * f + 5 * 2 * 8 * 2048 * e)
    assert abs(cs.PCIE5_X16_BYTES_PER_S / 1e9 - 63.015) < 1e-3


def test_copy_compute_overlap_reads_interval_unions():
    cs = _chip_smoke()
    assert cs.interval_union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    got = cs.copy_compute_overlap(copies=[(0, 10), (20, 30)], kernels=[(5, 25), (24, 26)])
    assert got["copy_ms"] == 20 / 1e3 and got["compute_ms"] == 21 / 1e3
    # [5, 10] and [20, 26] of the 20 us of copies run under a kernel
    assert got["overlap_ms"] == 11 / 1e3 and got["hidden_share"] == 11 / 20
    assert cs.copy_compute_overlap([], [(0, 1)])["hidden_share"] is None


def test_moe_gemm_kind_by_operand_shapes():
    """The Mixtral step's bf16 products: dispatch and combine carry the
    flattened experts x capacity axis, expert GEMMs are batched over the
    experts, the rest (attention, router) are other GEMMs."""
    cs = _chip_smoke()
    slots = 8 * 2048
    assert cs.moe_gemm_kind([[1, slots, 4096], [1, 4096, 4096]], 8, slots) == \
        "dispatch/combine einsums"
    assert cs.moe_gemm_kind([[4096, slots], [slots, 4096]], 8, slots) == \
        "dispatch/combine einsums"
    assert cs.moe_gemm_kind([[8, 2048, 4096], [8, 4096, 14336]], 8, slots) == "expert GEMMs"
    assert cs.moe_gemm_kind([[4096, 4096], [4096, 1024]], 8, slots) == "other GEMMs"
    assert cs.moe_gemm_kind([[4096, 4096], [], [4096, 4096]], 8, slots) == "other GEMMs"


def test_copy_rates_per_tier():
    cs = _chip_smoke()

    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, end):
            return end.t - self.t

    log = [{"tier": "cpu", "bytes": 2e9, "start": Ev(0), "end": Ev(100), "read_s": 0.0},
           {"tier": "disk", "bytes": 1e9, "start": Ev(0), "end": Ev(200), "read_s": 0.15},
           {"tier": "cpu", "bytes": 2e9, "start": Ev(0), "end": Ev(100), "read_s": 0.0}]
    got = cs.copy_rates(log, forwards=2)
    assert got["cpu"] == {"bytes_per_forward": 2e9, "copy_ms_per_forward": 100.0,
                          "gb_per_s": 20.0, "host_read_s_per_forward": 0.0}
    assert got["disk"]["gb_per_s"] == 5.0 and got["disk"]["host_read_s_per_forward"] == 0.075


def test_full_model_prediction_adds_exposed_copy_time_to_compute():
    """The 32-layer forward's prediction: the device budget leaves room for
    the two streamed layers in flight, and the copy time that the measured
    overlap does not hide adds to the compute time."""
    import torch

    cs = _chip_smoke()
    free = 80 * 10**9
    rates = {"cpu": {"gb_per_s": 50.0}}
    got = cs.full_model_prediction(torch, rates, {"hidden_share": 0.25}, 0.005, 10**9,
                                   free_bytes=free)
    layer = 2 * 1_451_270_144
    assert got["layer_bytes"] == layer and got["model_bytes"] == 2 * 46_702_792_704
    assert got["device_budget_bytes"] == 0.9 * free - 10**9 - 2 * layer
    streamed = got["model_bytes"] - got["device_budget_bytes"]
    assert got["streamed_bytes_per_forward"] == streamed
    assert got["copy_s"] == streamed / 50e9 and got["compute_s"] == 0.005 * 32
    assert got["predicted_s_per_forward"] == got["copy_s"] * 0.75 + 0.16
    # no overlap measured: every copy second is exposed
    none = cs.full_model_prediction(torch, rates, {"hidden_share": None}, 0.005, 10**9,
                                    free_bytes=free)
    assert none["predicted_s_per_forward"] == none["copy_s"] + 0.16


def test_t5_train_flops_counts_every_projection_and_attention_pair():
    """`t5_train_flops` against T5-v1.1-base's own parameters: 6 FLOPs per
    projection parameter a token (the encoder's over the source, the
    decoder's and the head's over the target) and 12 x heads x d_kv per
    attention pair."""
    from accelerate_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration

    smoke = _chip_smoke()
    cfg = T5Config.base()
    model = T5ForConditionalGeneration(cfg, device="meta")

    def linears(stack):
        return sum(m.weight.numel() for m in stack.modules() if isinstance(m, torch.nn.Linear))

    b, src, tgt = 16, 512, 128
    got = smoke.t5_train_flops(cfg, b, src, tgt)
    assert got["encoder_projections"] == 6 * linears(model.encoder) * b * src
    assert got["decoder_projections"] == 6 * linears(model.decoder) * b * tgt
    assert got["head"] == 6 * model.lm_head.numel() * b * tgt
    assert got["attention"] == 12 * 768 * b * (12 * src * src + 12 * (tgt * tgt + tgt * src))
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert 6.4e12 < got["total"] < 6.5e12


def test_data_parallel_child_imports_only_the_port_and_launches(tmp_path):
    """Phase 32's child is a script of its own (torch and the port, never
    JAX or the JAX package) with a mode for one NCCL rank and one for two
    gloo ranks; `launch_child` runs a script through the port's launcher
    from the repository root and returns its JSON lines."""
    import ast

    cs = _chip_smoke()
    roots = set()
    for node in ast.walk(ast.parse(cs.DATA_PARALLEL_CHILD)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"hashlib", "json", "math", "sys", "time", "numpy", "torch",
                     "accelerate_tpu_torch"}
    assert '{"nccl": nccl_world1, "gloo": gloo_two_ranks}' in cs.DATA_PARALLEL_CHILD
    script = tmp_path / "child.py"
    script.write_text("import json, os\n"
                      "print(json.dumps({'rank': int(os.environ['RANK']), "
                      "'world': int(os.environ['WORLD_SIZE'])}))\n")
    lines, stdout, seconds = cs.launch_child(["--debug_cpu", "2", str(script)], timeout=120)
    assert sorted(line["rank"] for line in lines) == [0, 1]
    assert all(line["world"] == 2 for line in lines) and seconds > 0
