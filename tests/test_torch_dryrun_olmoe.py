"""The one-card dry run of olmoe-1b-7b's four cells at full width and depth,
on the CPU (``launch/dryrun.py::run_cell``: the bundle on ``meta``,
priced by the op counter)."""
import pytest

from torch_dryrun import check_cell

ARCH = "olmoe-1b-7b"


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_dry_run(shape):
    check_cell(ARCH, shape)
