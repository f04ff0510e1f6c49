"""`chip_smoke.py`'s reading of a ptxas log: the flash forward kernels' and
the bf16 dQ and dK/dV kernels' registers, spills and static shared memory,
which its build phase prints and holds to zero spills. Runs on the CPU against a log in
ptxas's format."""

import importlib.util
from pathlib import Path

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
