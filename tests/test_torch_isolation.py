"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import numpy as np
import repro_torch as rt
from repro_torch.index.corpus import synthesize_corpus, synthesize_topics
corpus = synthesize_corpus(n_docs=400, vocab=3000, mean_len=40, seed=1)
topics = synthesize_topics(corpus, n_topics=3, q_len=3, rels_per_topic=5,
                           seed=2)
be = rt.TorchBackend(rt.build_index(corpus, device="cpu"), default_k=20,
                     device="cpu")
Q = rt.make_queries(topics.terms, topics.weights, topics.qids, device="cpu")
pipes = [rt.Retrieve("BM25") % 5,
         (rt.Retrieve("BM25") >> (rt.Extract("QL") ** rt.Extract("DPH"))) % 5]
pipes += [(rt.Retrieve("BM25", k=30) >> rt.DenseRerank(alpha=0.3)) % 5,
          rt.DenseRetrieve(k=5, nprobe=2) % 5,
          rt.DenseRetrieve(k=5, nprobe=2, pq=True) % 5]
res = rt.Experiment(pipes, Q, topics.qrels, ["map"], backend=be)
assert res["results"][1]["features"].shape == (3, 5, 2)
assert all(r["docids"].shape == (3, 5) for r in res["results"][2:])
desc = (rt.BackendDescriptor.default(frozenset({"fused_topk"}), device="cpu")
        .with_autotune(True, band=10.0, probe_queries=1, probe_repeats=1))
rep = {}
rt.compile_pipeline(rt.Retrieve("BM25") % 5,
                    rt.TorchBackend(be.index, default_k=20, device="cpu",
                                    descriptor=desc), report=rep)
assert rep["tuning"]["probe_measurements"] == 2
import torch
from repro_torch.configs import qwen2_1_5b
from repro_torch.models.transformer_lm import LMConfig
assert qwen2_1_5b.model_cfg().n_layers == 28
cfg = LMConfig(name="t", n_layers=1, d_model=32, n_q=4, n_kv=2, d_head=8,
               d_ff=64, vocab=128, dtype=torch.float32, attn_impl="pallas")
be.register_lm("t", cfg)
rag = (rt.Retrieve("BM25") >> rt.DenseRerank() % 4
       >> rt.Generate("t", max_new_tokens=3, max_prompt_len=16,
                      prompt_docs=2))
assert rt.run_pipeline(rag, Q, backend=be)["tokens"].shape == (3, 3)
import tempfile
prf = (rt.Retrieve("BM25") >> rt.RM3Expand(fb_docs=3, fb_terms=4)
       >> rt.Retrieve("BM25")) % 5
ltr = ((rt.Retrieve("BM25") >> (rt.Extract("QL") ** rt.Extract("DPH"))) % 5
       >> rt.LTRRerank(n_features=2, epochs=3))
ltr.fit(Q, topics.qrels, backend=be)
with tempfile.TemporaryDirectory() as d:
    for _ in range(2):
        cache = rt.ArtifactCache(d)
        res = rt.Experiment([prf, ltr], Q, topics.qrels, ["map"], backend=be,
                            artifact_cache=cache, measure_time=True)
    assert cache.hits > 0 and res["plan"].n_stage_executions == 5
assert res["results"][1]["docids"].shape == (3, 5)
assert be.engine is not None and be.engine.total_compiles() > 0
server = rt.MultiPipelineServer({"bm25": rt.Retrieve("BM25") % 5, "rag": rag},
                                be, rt.ServeConfig.default().with_decode(2))
server.warmup(Q)
row = {k: v[:1] for k, v in Q.items()}
assert server.submit_wait(row)["docids"].shape == (1, 5)
assert server.submit_wait(row, pipeline="rag")["tokens"].shape == (1, 3)
assert server.stats()["recompiles_since_warmup"] == 0
from repro_torch.configs.registry import all_arch_ids
from repro_torch.launch.train import train_lm
from repro_torch.train import checkpoint, compression, fault
assert len(all_arch_ids()) == 10
from repro_torch.configs.registry import get_arch
from repro_torch.models import sampler
for arch_id in ("dcn-v2", "autoint", "dien", "mind", "gat-cora"):
    arch = get_arch(arch_id)
    zcfg, zbatch = arch.reduced()
    zmod = arch.module.init_params(zcfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    zb = {k: torch.as_tensor(v) for k, v in zbatch().items()}
    assert torch.isfinite(arch.module.loss_fn(zcfg, zmod, zb)[0])
sub = sampler.NeighborSampler(sampler.random_graph(50, 4, 16, 5),
                              [3, 2]).sample(np.arange(4))
assert sub["src"].shape == (4 * 3 + 4 * 3 * 2,)
with tempfile.TemporaryDirectory() as d:
    state, ce = train_lm("olmoe-1b-7b", steps=2, batch=2, seq=16, ckpt_dir=d,
                         ckpt_every=1, attn_impl="flash", n_micro=2,
                         device="cpu")
    assert checkpoint.latest_step(d) == 2 and len(ce) == 2
ef = compression.ErrorFeedback("topk", 0.5)
ef.compress_decompress({"w": torch.ones(4)}, ef.init({"w": torch.ones(4)}))
assert fault.ElasticMesh(1).build(["cpu"]).shape == (1, 1)
from repro_torch.launch import dryrun, pipeline_dryrun, serve, steps
from repro_torch.examples import (ltr_experiment, quickstart, serve_pipeline,
                                  train_lm as train_example)
b = steps.build_bundle("gat-cora", "molecule", device="cpu")
b.fn(*b.args)
assert dryrun.run_cell("dcn-v2", "serve_p99", verbose=False)["fits"]
assert len(serve.serve_demo("qwen2-1.5b", n_requests=2, max_new=2,
                            device="cpu")) == 2
with tempfile.TemporaryDirectory() as d:
    assert len(train_example.run("10m", 1, ckpt_dir=d, device="cpu")) == 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("LOADED", bad)
"""


def test_subprocess_run_loads_no_jax_and_no_reference_package():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_no_source_file_imports_jax_or_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    assert ROOT / "src" / "repro_torch" / "analysis" / "op_cost.py" in files
    for mod in ("train/optimizer.py", "train/train_step.py", "train/data.py",
                "train/checkpoint.py", "train/compression.py",
                "train/fault.py", "launch/train.py", "configs/registry.py",
                "configs/shapes.py", "models/param_tree.py",
                "models/recsys/embedding.py", "models/recsys/dcn.py",
                "models/recsys/autoint.py", "models/recsys/dien.py",
                "models/recsys/mind.py", "models/gnn.py",
                "models/sampler.py", "configs/gat_cora.py",
                "configs/dcn_v2.py", "configs/dien.py", "configs/mind.py",
                "configs/autoint.py", "launch/steps.py",
                "launch/dryrun.py", "launch/pipeline_dryrun.py",
                "launch/serve.py", "launch/mesh.py",
                "examples/quickstart.py", "examples/ltr_experiment.py",
                "examples/serve_pipeline.py", "examples/train_lm.py"):
        assert ROOT / "src" / "repro_torch" / mod in files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_is_the_card(monkeypatch):
    from repro_torch.core.compiler import TorchBackend
    from repro_torch.core.data import empty_results, make_queries
    from repro_torch.index import build_index
    from repro_torch.index.corpus import synthesize_corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = synthesize_corpus(n_docs=200, vocab=1000, mean_len=20, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index(corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_queries([[1, 2, -1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        empty_results(2, 5)
    index = build_index(corpus, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(index)
    assert TorchBackend(index, device="cpu").device.type == "cpu"
    from repro_torch.core.engine import ShardedQueryEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedQueryEngine()
    assert ShardedQueryEngine("cpu").device.type == "cpu"
    from repro_torch.launch.train import train_lm
    from repro_torch.train.fault import ElasticMesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm("qwen2-1.5b", steps=1, batch=2, seq=8, ckpt_dir="unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticMesh(1).build()
    from repro_torch.configs.registry import get_arch
    for arch_id in ("dcn-v2", "autoint", "dien", "mind", "gat-cora"):
        arch = get_arch(arch_id)
        cfg = arch.reduced()[0]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arch.module.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arch.module.from_arrays(cfg, {})
        assert all(p.device.type == "cpu" for p in arch.module.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu").parameters())
