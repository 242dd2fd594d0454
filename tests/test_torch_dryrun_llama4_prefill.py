"""The one-card dry run of llama4-scout-17b-a16e x prefill_32k at full
width and depth, on the CPU (its 48 layers' einsum attention in 4,096 query
blocks a layer make it the longest cell to price)."""
from torch_dryrun import check_cell


def test_dry_run():
    check_cell("llama4-scout-17b-a16e", "prefill_32k")
