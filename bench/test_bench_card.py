"""The harness on a CUDA card at the tiny size: a traced run reads the
device's busy time and every per-layer metric of the cell, and the
control still fails the check.  Skips without a card (decided inside
the test, never at import)."""
from __future__ import annotations

import time

import pytest
import torch

import check
import harness
import tinycell


@pytest.mark.parametrize("name", ["rq2-fat.t250", "rq1-topk.t250-at10"])
def test_traced_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    cell = tinycell.tiny(name)
    out = harness.run(cell, 123456789012, 0.5, True, "cuda",
                      time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    ctl = {k: v["value"] for k, v in out["control_checks"].items()}
    assert not check.verdict(ctl, cell.spec["limits"])
