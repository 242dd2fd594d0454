"""The port's examples and serving demo against the JAX package's on the
CPU: ``repro_torch.examples.{quickstart,ltr_experiment,serve_pipeline,
train_lm}`` against ``examples/*.py``, and ``launch.serve.serve_demo``
against ``repro.launch.serve.serve_demo``, each at its own sizes (nothing
is cut).

The JAX examples run as they are, with ``REPRO_ENGINE=sequential`` (on
jax 0.9.0 the default sharded engine raises for every ``Retrieve``:
ROADMAP §3).  What the port draws from its own generators is carried over
from the JAX run by monkeypatching the draw, never by a new argument: the
LTR stage's initial state (``ltr_state_from_arrays``), the RAG LM's
weights (``register_lm(params=...)``) and the training LM's
(``lm_from_arrays``).  Experiment measures agree within 1e-6, as
``tests/test_torch_ltr.py``'s; rankings and tokens are equal."""
import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiler as jcompiler
from repro.launch import serve as jserve
from repro.models import transformer_lm as JT
from repro_torch.core import compiler as tcompiler
from repro_torch.examples import ltr_experiment as tltr
from repro_torch.examples import quickstart as tquick
from repro_torch.examples import serve_pipeline as tserve_ex
from repro_torch.examples import train_lm as ttrain
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer_lm as TT
from repro_torch.models.ltr import ltr_state_from_arrays

ROOT = Path(__file__).resolve().parents[1]
MEASURE_ATOL = 1e-6
RULES = re.compile(r"^(\w+)\s.*\n\s+-->\s+(.*?)\s+\(rules: (\[.*\])\)$",
                   re.M)


def jax_example(name: str):
    """``examples/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def sequential(monkeypatch):
    monkeypatch.setenv("REPRO_ENGINE", "sequential")


def spy_experiment(monkeypatch, module) -> list:
    """Record every Experiment result that ``module`` computes."""
    out = []
    real = module.Experiment

    def spy(*a, **kw):
        res = real(*a, **kw)
        out.append(res)
        return res

    monkeypatch.setattr(module, "Experiment", spy)
    return out


def assert_tables_close(got: dict, want: dict, metrics):
    assert [r["name"] for r in got["table"]] == \
        [r["name"] for r in want["table"]]
    for g, w in zip(got["table"], want["table"]):
        for m in metrics:
            assert abs(g[m] - w[m]) <= MEASURE_ATOL, (g["name"], m, g[m],
                                                       w[m])


def test_quickstart_matches_reference(monkeypatch, capsys, sequential):
    """The three rewrite traces and their optimised forms, the IR listing
    of ``bm25 % 10``, and the Experiment's table."""
    jex = jax_example("quickstart")
    jres = spy_experiment(monkeypatch, jex)
    jex.main()
    jout = capsys.readouterr().out
    got = tquick.run("cpu")
    tout = capsys.readouterr().out
    assert RULES.findall(tout) == RULES.findall(jout)
    assert len(RULES.findall(tout)) == 3
    assert {n: str(r) for n, _, r in RULES.findall(tout)} == \
        {n: str(r) for n, r in got["traces"].items()}
    assert got["explain"] in jout
    assert_tables_close(got["result"], jres[0],
                        ["map", "ndcg_cut_10", "P_10"])


def test_ltr_experiment_matches_reference(monkeypatch, sequential):
    """Listing 1 with the LTR stage started from the JAX stage's initial
    state: all four rows' measures."""
    jex = jax_example("ltr_experiment")
    drawn = []
    real_j = jex.LTRRerank

    def j_ltr(**kw):
        stage = real_j(**kw)
        drawn.append({k: np.asarray(v) for k, v in stage.state.items()})
        return stage

    monkeypatch.setattr(jex, "LTRRerank", j_ltr)
    jres = spy_experiment(monkeypatch, jex)
    jex.main()
    real_t = tltr.LTRRerank

    def t_ltr(**kw):
        stage = real_t(**kw)
        stage.state = ltr_state_from_arrays(drawn[0], "cpu")
        return stage

    monkeypatch.setattr(tltr, "LTRRerank", t_ltr)
    got = tltr.run("cpu")
    assert len(drawn) == 1
    assert_tables_close(got["result"], jres[0],
                        ["map", "ndcg_cut_10", "P_10"])


def test_serve_pipeline_matches_reference(monkeypatch, capsys, sequential):
    """The Experiment's table, the served dense tenant's top-5 docids, and
    the RAG answers' tokens from the JAX draw of the demo LM."""
    jex = jax_example("serve_pipeline")
    lms = {}
    real_j = jcompiler.JaxBackend.register_lm

    def j_register(self, name, cfg, params=None, **kw):
        real_j(self, name, cfg, params, **kw)
        lms[name] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 self.lm(name)[1])
        return self

    monkeypatch.setattr(jcompiler.JaxBackend, "register_lm", j_register)
    jres = spy_experiment(monkeypatch, jex)
    jex.main()
    jout = capsys.readouterr().out
    real_t = tcompiler.TorchBackend.register_lm

    def t_register(self, name, cfg, params=None, **kw):
        return real_t(self, name, cfg,
                      TT.lm_from_arrays(cfg, lms[name], self.device), **kw)

    monkeypatch.setattr(tcompiler.TorchBackend, "register_lm", t_register)
    got = tserve_ex.run("cpu")
    tout = capsys.readouterr().out
    assert_tables_close(got["result"], jres[0], ["map", "ndcg_cut_10"])
    for line in ("rid=1 top-5 docids:", "rid=0 answer tokens:"):
        want = [x for x in jout.splitlines() if x.startswith(line)]
        assert want and [x for x in tout.splitlines()
                         if x.startswith(line)] == want, line
    assert got["stats"]["served"] == 24
    assert got["rag_stats"]["decode"]["requests"] == 12
    assert all(np.asarray(a["tokens"]).shape == (1, 8)
               for a in got["answers"])


def test_train_lm_matches_reference(monkeypatch, tmp_path):
    """The 10m preset (d_head 32, ``attn_impl="flash"``, n_micro 2) from
    the JAX draw, in float32 on both sides (set through ``LMConfig``): the
    first three ce within rtol 1e-4, ``tests/test_torch_train_lm.py``'s
    bound."""
    jex = jax_example("train_lm")
    monkeypatch.setattr(jex.tlm, "LMConfig", functools.partial(
        JT.LMConfig, dtype=jnp.float32))
    monkeypatch.setattr(ttrain.tlm, "LMConfig", functools.partial(
        TT.LMConfig, dtype=torch.float32))
    drawn = {}
    real_init = JT.init_params

    def spy_init(cfg, key):
        params = real_init(cfg, key)      # donated to the first step
        drawn["tree"] = jax.tree.map(lambda a: np.array(a, np.float32),
                                     params)
        return params

    monkeypatch.setattr(JT, "init_params", spy_init)
    ce = []
    real_guard = jex.StepGuard

    class Guard(real_guard):
        def run(self, state, factory, step_fn, n_steps, **kw):
            def logged(state, batch):
                state, m = step_fn(state, batch)
                ce.append(float(m["ce"]))
                return state, m
            return super().run(state, factory, logged, n_steps, **kw)

    monkeypatch.setattr(jex, "StepGuard", Guard)
    monkeypatch.setattr(sys, "argv", [
        "train_lm.py", "--preset", "10m", "--steps", "3",
        "--ckpt-dir", str(tmp_path / "jax")])
    jex.main()
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen: TT.lm_from_arrays(
        cfg, drawn["tree"], gen.device))
    got = ttrain.run("10m", 3, ckpt_dir=str(tmp_path / "port"),
                     device="cpu")
    assert len(got) == len(ce) == 3
    np.testing.assert_allclose(got, ce, rtol=1e-4)


def test_train_lm_keeps_the_reference_presets():
    jex = jax_example("train_lm")
    assert ttrain.PRESETS == jex.PRESETS
    assert ttrain.CKPT_DIR.parent == ROOT / "build"


def test_serve_demo_matches_reference(monkeypatch, capsys):
    """Every request served with the tokens of the reference's pool, from
    the reference's draw of the reduced Qwen2 (bf16 on both sides)."""
    drawn = {}
    real_init = JT.init_params

    def spy_init(cfg, key):
        params = real_init(cfg, key)
        drawn["tree"] = jax.tree.map(lambda a: np.array(a, np.float32),
                                     params)
        return params

    monkeypatch.setattr(JT, "init_params", spy_init)
    want = jserve.serve_demo("qwen2-1.5b")
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen: TT.lm_from_arrays(
        cfg, drawn["tree"], gen.device))
    got = tserve.serve_demo("qwen2-1.5b", device="cpu")
    assert len(got) == len(want) == 8
    assert [(r.rid, list(r.prompt), r.generated) for r in got] == \
        [(r.rid, list(r.prompt), r.generated) for r in want]
    assert all(len(r.generated) == 12 for r in got)
    assert "served 8/8 requests, 96 tokens" in capsys.readouterr().out


def test_entry_points_take_the_card_by_default(monkeypatch):
    """Without a device argument each runs on the card, and without one
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tquick.run(), lambda: tltr.run(),
                 lambda: tserve_ex.run(), lambda: ttrain.run("10m", 1),
                 lambda: tserve.serve_demo("qwen2-1.5b")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

