"""The port's small utils against the reference's: `utils.constants`,
`utils.imports`, `utils.versions` and `utils.tqdm`."""

import pytest

pytest.importorskip("jax")

from accelerate_tpu.utils import constants as jconstants  # noqa: E402
from accelerate_tpu.utils import imports as jimports  # noqa: E402
from accelerate_tpu.utils import versions as jversions  # noqa: E402
from accelerate_tpu_torch import checkpointing  # noqa: E402
from accelerate_tpu_torch.utils import constants, imports, versions  # noqa: E402
from accelerate_tpu_torch.utils.tqdm import tqdm  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_constants_equal_the_reference_and_name_the_checkpoint_files():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names == [n for n in dir(constants) if n.isupper()]
    for name in names:
        assert getattr(constants, name) == getattr(jconstants, name), name
    assert checkpointing.MODEL_NAME is constants.MODEL_NAME
    assert checkpointing.CHECKPOINT_COMPLETE_MARKER is constants.CHECKPOINT_COMPLETE_MARKER


def test_availability_checks_agree_with_the_reference():
    checks = [n for n in dir(imports) if n.startswith("is_") and n.endswith("_available")]
    shared = [n for n in checks if hasattr(jimports, n)]
    assert set(checks) - set(shared) == {"is_cuda_available"}
    for name in shared:
        assert getattr(imports, name)() == getattr(jimports, name)(), name
    assert imports.is_cuda_available() is False  # the CPU host of these tests


@pytest.mark.parametrize("a, op, b", [("2.11.0+cu128", ">=", "2.11"), ("2.4.0rc1", "<", "2.4.0"),
                                      ("0.4.30", "<", "0.5"), ("1.0", "==", "1.0.0"),
                                      ("numpy", ">", "1.0"), ("3.1.4", "!=", "3.1.4")])
def test_compare_versions_matches_reference(a, op, b):
    assert versions.compare_versions(a, op, b) == jversions.compare_versions(a, op, b)
    with pytest.raises(ValueError, match="operation"):
        versions.compare_versions(a, "~=", b)
    assert versions.is_torch_version(">=", "2.0")


def test_tqdm_renders_on_the_one_process():
    if not imports.is_tqdm_available():
        with pytest.raises(ImportError, match="tqdm"):
            tqdm(range(3))
        return
    bar = tqdm(range(3), main_process_only=True, disable=False)
    assert not bar.disable
    assert list(bar) == [0, 1, 2]
