"""The checks every dry-run record of ``repro_torch.launch.dryrun`` passes
(``tests/test_torch_dryrun_*.py``, one file a family or LM, so that the
suite's workers share them)."""
import math

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.steps import build_bundle

#: the reference's record keys that mean the same on one card, and `fits`
KEYS = {"arch", "shape", "n_chips", "memory", "bytes_per_device",
        "flops_per_chip", "bytes_per_chip", "collectives",
        "collective_bytes_per_chip", "collective_counts", "model_flops",
        "t_compute", "t_memory", "t_collective", "bottleneck",
        "useful_flops_ratio", "fits"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes"}


def check_cell(arch_id: str, shape: str) -> dict:
    """``run_cell`` on the CPU, without a card, and its record's keys and
    arithmetic."""
    rec = dryrun.run_cell(arch_id, shape, verbose=False)
    assert KEYS <= rec.keys(), KEYS - rec.keys()
    assert rec["n_chips"] == 1 and rec["t_collective"] == 0.0
    assert rec["collectives"] == rec["collective_counts"] == {}
    mem = rec["memory"]
    assert mem.keys() == MEMORY_KEYS
    assert rec["bytes_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
    assert mem["temp_bytes"] >= 0 and mem["alias_bytes"] <= \
        min(mem["argument_bytes"], mem["output_bytes"])
    assert rec["fits"] == (rec["bytes_per_device"] <= mesh.HBM_BYTES)
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    dtype = get_arch(arch_id).model_cfg(shape).dtype
    assert math.isclose(rec["t_compute"],
                        rec["flops_per_chip"] / mesh.peak_flops(dtype))
    assert mesh.peak_flops(dtype) == (mesh.PEAK_FLOPS_BF16
                                      if dtype == torch.bfloat16
                                      else mesh.PEAK_FLOPS_FP32)
    assert math.isclose(rec["t_memory"], rec["bytes_per_chip"] / mesh.HBM_BW)
    assert rec["bottleneck"] == ("compute" if rec["t_compute"] >
                                 rec["t_memory"] else "memory")
    assert rec["model_flops"] == build_bundle(
        arch_id, shape, device="meta").model_flops_per_step
    assert math.isclose(rec["useful_flops_ratio"],
                        rec["model_flops"] / rec["flops_per_chip"])
    return rec
