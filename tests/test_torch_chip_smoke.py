"""`chip_smoke.py`'s reading of a ptxas log: the flash forward kernels' and
the bf16 dQ, dK/dV and fused-CE forward, dH and dW kernels' registers,
spills and static shared memory, which its build phase prints and holds to
zero spills; its split of profiled kernel names into the fused-CE forward,
dH and dW; and its serving bookkeeping: kernel launches counted through
decode graph replays, and the fields of a serving line. Runs on the CPU
against a log in ptxas's format and a CPU engine."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import torch

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
