"""Whole runs of every cell at a tiny size on the CPU (the look for a card
skipped): the program's outputs pass the check, the control (the
reference in the precision below, in the program's place) fails it, and
a run whose timed path alters an answer where it is produced comes out
not correct."""
from __future__ import annotations

import time

import pytest

import check
import harness
import tinycell

CELLS = [w.name for w in [harness.Cell.load(n) for n in (
    "rq2-fat.t250", "rag-qwen2.t250", "rq1-topk.t250-at10")]]
SEED = 2 ** 31 + 77


def _run(name, control=False, trace=False):
    return harness.run(tinycell.tiny(name), SEED, 0.3, trace, "cpu",
                       time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct_and_the_control_is_not(name):
    out = _run(name, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   harness.Cell.load(name).end_to_end}
    assert list(out)[-1] == "checks"
    ctl = {k: v["value"] for k, v in out["control_checks"].items()}
    assert not check.verdict(ctl, tinycell.tiny(name).spec["limits"]), ctl


@pytest.mark.parametrize("name", ["rq2-fat.t250", "rq1-topk.t250-at10"])
def test_traced_run_reads_per_layer_metrics(name):
    out = _run(name, trace=True)
    assert out["correct"]
    names = {m["name"] for m in harness.Cell.load(name).per_layer}
    assert set(out["metrics"]) <= names
    assert "engine.compiles_in_window.batch" in out["metrics"]


@pytest.mark.parametrize("name", ["rq2-fat.t250", "rq1-topk.t250-at10"])
def test_window_draws_no_topics(name, monkeypatch):
    """Every call's topics and judgements are drawn before the window."""
    orig = harness.experiment_window

    def window(cell, rt, be, pipe, draw, pre, *args):
        def refuse():
            raise AssertionError("topics drawn inside the window")
        return orig(cell, rt, be, pipe, refuse, pre, *args)
    monkeypatch.setattr(harness, "experiment_window", window)
    assert _run(name)["correct"]


def test_setup_leaves_out_the_kernel_build(monkeypatch):
    """``setup_s`` runs to the window's start, less the kernel build."""
    seen = {}
    orig = harness.experiment_window

    def build(device):
        time.sleep(0.5)
        return 0.5

    def window(*args):
        seen["t"] = time.perf_counter()
        return orig(*args)
    monkeypatch.setattr(harness, "kernel_build", build)
    monkeypatch.setattr(harness, "experiment_window", window)
    t0 = time.perf_counter()
    out = harness.run(tinycell.tiny("rq1-topk.t250-at10"), SEED, 0.1, False,
                      "cpu", t0)
    setup = out["metrics"]["setup_s"]["value"]
    assert 0 < seen["t"] - t0 - 0.5 - setup < 0.05


def _swap_docs(out):
    docs = out[0].clone()
    docs[:, 0] = docs[:, -1]
    return (docs,) + tuple(out[1:])


FAULTS = {
    # an answer altered where it is produced: a wrong document at rank 0
    "rq2-fat.t250": ("repro_torch.index.retrieve", "retrieve_fat_fused",
                     _swap_docs),
    "rq1-topk.t250-at10": ("repro_torch.index.retrieve", "retrieve_topk_fused",
                      lambda out: (out[0].flip(-1),) + tuple(out[1:])),
    # a generated token altered where the decode produces it
    "rag-qwen2.t250": ("repro_torch.core.stages", "greedy_generate_fn",
                       None),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    import importlib
    mod_name, attr, alter = FAULTS[name]
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)
    if alter is None:
        def broken(cfg, **kw):
            gen = orig(cfg, **kw)

            def run(lm, prompts, n_rows=None):
                toks = gen(lm, prompts, n_rows).clone()
                toks[:, 1] = (toks[:, 1] + cfg.vocab // 2) % cfg.vocab
                return toks
            return run
    else:
        def broken(*args, **kwargs):
            return alter(orig(*args, **kwargs))
    monkeypatch.setattr(mod, attr, broken)
    out = _run(name)
    assert not out["correct"], out["checks"]


def test_cell_refuses_a_wrong_lowering():
    cell = tinycell.tiny("rq1-topk.t250-at10")
    cell.spec["lowers_to"] = ["retrieve"]
    with pytest.raises(RuntimeError, match="lowers to"):
        harness.run(cell, SEED, 0.1, False, "cpu", time.perf_counter())
