"""The one-card dry run of the model zoo's 20 cells (DCN-v2, AutoInt,
DIEN, MIND at the four recsys cells, gat-cora at the four graph cells) at
their published sizes, on the CPU, with the peaks of the cells that a
card holds."""
import pytest

from repro_torch.configs.registry import get_arch
from torch_dryrun import check_cell

CELLS = [(a, s) for a in ("dcn-v2", "autoint", "dien", "mind", "gat-cora")
         for s in get_arch(a).shapes]


@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_dry_run(arch_id, shape):
    rec = check_cell(arch_id, shape)
    # every zoo cell fits one card (PERF.md §4: phase Z runs them all)
    assert rec["fits"], rec["bytes_per_device"]
    assert rec["bottleneck"] in ("compute", "memory")
