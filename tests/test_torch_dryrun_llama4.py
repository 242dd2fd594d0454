"""The one-card dry run of llama4-scout-17b-a16e's train and decode cells
at full width and depth, on the CPU (``launch/dryrun.py::run_cell``: the
bundle on ``meta``, priced by the op counter); its prefill, the longest to
price, is ``test_torch_dryrun_llama4_prefill.py``, so that another worker
takes it."""
import pytest

from torch_dryrun import check_cell

ARCH = "llama4-scout-17b-a16e"


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_dry_run(shape):
    check_cell(ARCH, shape)
