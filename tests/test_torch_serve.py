"""The port's serving layer (``serve/*``, the decode pool's ragged step in
``models/transformer_lm.py``) against the JAX package, on the
tests/conftest.py corpus.

The schedulers of both packages get the same submission scripts under one
fake clock and must close the same batches.  The servers serve the same
rows over the port's engine backend and the reference's sequential backend
(``sharded=False``): sparse rankings and features must equal the port's
``run_pipeline`` bit for bit and the reference server's at the ranking
tolerance (rtol 2e-5 / atol 1e-5, docids equal except inside a score tie);
the RAG tenant's tokens, on a tiny float32 LM carried across with
``lm_from_arrays``, must equal the offline ``Generate`` and the reference
server's exactly."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as JS
import repro_torch as rt
import repro_torch.serve as TS
from repro.core.compiler import JaxBackend
from repro.index.inverted import build_index as jbuild
from repro.serve import batching as jbatching
from repro_torch.index import dense as TD
from repro_torch.index.inverted import build_index as tbuild
from repro_torch.models import transformer_lm as TT
from repro_torch.serve.batching import ContinuousBatcher, Request

from test_torch_generate import _carry, _port_cfg, _tiny_jcfg
from torch_parity import (assert_ranking_parity, jax_queries, small_env,
                          torch_queries)

class FakeClock:
    """``time.monotonic`` for both packages' schedulers and servers."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


# ---------------------------------------------------------------------------
# the scheduler: one script, both packages, the same batches
# ---------------------------------------------------------------------------

def _req(S, rid, deadline=None, lane="default"):
    return S.ServeRequest(rid=rid, Q=None, deadline=deadline, lane=lane,
                          trace=S.RequestTrace(rid=rid))


def _drain(sch):
    out = []
    while (b := sch.next_batch(drain=True)) is not None:
        out.append((b.reason, [r.rid for r in b.requests],
                    [r.rid for r in b.shed]))
    return out


def _edf_mixed(S, clock):
    sch = S.MicroBatchScheduler(ladder=(8,), max_wait_ms=1000.0)
    now = clock()
    for rid, dl in ((0, 5.0), (1, None), (2, 1.0), (3, 3.0), (4, None)):
        sch.submit(_req(S, rid, None if dl is None else now + dl))
    out = _drain(sch)
    assert out[0][1] == [2, 3, 0, 1, 4]
    return out


def _edf_fifo(S, clock):
    sch = S.MicroBatchScheduler(ladder=(4, 8), max_wait_ms=1000.0)
    for i in range(19):
        sch.submit(_req(S, i))
    out = _drain(sch)
    assert [(r, len(b)) for r, b, _ in out] == \
        [("full", 8), ("full", 8), ("drain", 3)]
    return out


def _shed_at_submit(S, clock):
    sch = S.MicroBatchScheduler(ladder=(8,))
    sch.note_service_time(0.1)
    now = clock()
    shed = []
    for rid in (0, 1):
        with pytest.raises(S.DeadlineUnmeetable):
            sch.submit(_req(S, rid, now + 0.01))
        shed.append(rid)
    sch.submit(_req(S, 2, now + 10.0))
    assert sch.stats()["shed_submit"] == 2 and sch.qsize() == 1
    return shed, _drain(sch)


def _shed_queue_wait_ahead(S, clock):
    sch = S.MicroBatchScheduler(ladder=(4,))
    sch.note_service_time(0.1)
    now = clock()
    for i in range(8):
        sch.submit(_req(S, i, now + 10.0))
    with pytest.raises(S.DeadlineUnmeetable):
        sch.submit(_req(S, 9, now + 0.15))
    sch.submit(_req(S, 10, now + 0.5))
    return _drain(sch)


def _shed_at_batch_close(S, clock):
    sch = S.MicroBatchScheduler(ladder=(2,))
    now = clock()
    sch.submit(_req(S, 0, now + 0.02))
    sch.submit(_req(S, 1, now + 30.0))
    sch.submit(_req(S, 2, now + 30.0))
    sch.note_service_time(0.1)
    clock.sleep(0.03)
    out = _drain(sch)
    assert out[0][2] == [0] and out[0][1] == [1, 2]
    assert sch.stats()["shed_queue"] == 1
    return out


def _estimate_by_bucket(S, clock):
    sch = S.MicroBatchScheduler(ladder=(2, 4, 8))
    sch.note_service_time(0.4, 4)
    est = [sch.service_estimate(n) for n in (None, 3, 1, 8)]
    sch.note_service_time(0.3, 8)
    est.append(sch.service_estimate(8))
    assert est == pytest.approx([0.4, 0.4, 0.2, 0.8, 0.3])
    return est


def _affine_fit(S, clock):
    sch = S.MicroBatchScheduler(ladder=(2, 4, 8, 16))
    sch.note_service_time(0.2, 2)
    sch.note_service_time(0.44, 8)
    est = [sch.service_estimate(4), sch.service_estimate(16)]
    assert est == pytest.approx([0.28, 0.76], rel=1e-6)
    return est


def _deadline_cap(S, clock):
    sch = S.MicroBatchScheduler(ladder=(2, 4, 8), max_wait_ms=1000.0)
    for _ in range(8):
        sch.note_service_time(0.8, 8)
    now = clock()
    sch.submit(_req(S, 0, now + 0.3))
    for i in range(1, 8):
        sch.submit(_req(S, i, now + 30.0))
    out = _drain(sch)
    assert out[0][1] == [0, 1] and len(out[1][1]) == 6
    return out


def _no_shed_before_measurement(S, clock):
    sch = S.MicroBatchScheduler(ladder=(8,))
    now = clock()
    sch.submit(_req(S, 0, now + 0.001))
    with pytest.raises(S.DeadlineUnmeetable):
        sch.submit(_req(S, 1, now - 1.0))
    return _drain(sch)


def _wfq_weights(S, clock):
    sch = S.MicroBatchScheduler(ladder=(8,), lanes=(("fg", 3.0), ("bg", 1.0)),
                                default_lane="fg")
    for i in range(32):
        sch.submit(_req(S, i, lane="fg" if i < 16 else "bg"))
    out = _drain(sch)
    assert sum(r < 16 for r in out[0][1]) == 6
    return out


def _wfq_no_starvation(S, clock):
    sch = S.MicroBatchScheduler(ladder=(4,), lanes=(("interactive", 4.0),
                                                    ("background", 1.0)),
                                default_lane="interactive")
    for i in range(100):
        sch.submit(_req(S, i, lane="background"))
    first = sch.next_batch(drain=True)
    for i in range(100, 104):
        sch.submit(_req(S, i, lane="interactive"))
    second = sch.next_batch(drain=True)
    assert sum(r.rid >= 100 for r in second.requests) >= 3
    return ([r.rid for r in first.requests], [r.rid for r in second.requests])


def _unknown_lane(S, clock):
    with pytest.raises(KeyError):
        S.MicroBatchScheduler(ladder=(4,)).submit(_req(S, 0, lane="nope"))
    return "KeyError"


def _adaptive_wait(S, clock):
    sch = S.MicroBatchScheduler(ladder=(64,), max_wait_ms=100.0,
                                adaptive_wait=True)
    for i in range(4):
        sch.submit(_req(S, i))
        clock.sleep(0.001)
    st = sch.stats()
    assert st["effective_wait_ms"] < 100.0
    return st["arrival_gap_ewma_ms"], st["effective_wait_ms"]


SCRIPTS = [_edf_mixed, _edf_fifo, _shed_at_submit, _shed_queue_wait_ahead,
           _shed_at_batch_close, _estimate_by_bucket, _affine_fit,
           _deadline_cap, _no_shed_before_measurement, _wfq_weights,
           _wfq_no_starvation, _unknown_lane, _adaptive_wait]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[1:])
def test_scheduler_closes_the_same_batches(script, clock):
    t0 = clock.t
    want = script(JS, clock)
    clock.t = t0
    got = script(TS, clock)
    assert got == want


def test_scheduler_bucket_is_the_engines_rule():
    eng = rt.ShardedQueryEngine("cpu")
    sch = TS.MicroBatchScheduler(ladder=eng.ladder)
    for n in range(1, eng.ladder[-1] + 1):
        assert sch.select_bucket(n) == eng.select_bucket(n)
    assert sch.select_bucket(eng.ladder[-1] + 1) == eng.ladder[-1]
    with pytest.raises(ValueError):
        eng.select_bucket(eng.ladder[-1] + 1)


# ---------------------------------------------------------------------------
# servers over both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    corpus, topics, _ = small_env()
    jbe = JaxBackend(jbuild(corpus), default_k=60, query_chunk=4,
                     sharded=False)
    dense = TD.dense_from_arrays(np.asarray(jbe.dense.emb), "cpu")
    tidx = tbuild(corpus, device="cpu")

    def port(**kw):
        return rt.TorchBackend(tidx, dense, default_k=60, device="cpu",
                               **kw)

    jcfg = _tiny_jcfg("float32", "pallas")
    params, lm = _carry(jcfg, seed=2)
    jbe.register_lm("tiny", jcfg, params)
    tbe = port()
    tbe.register_lm("tiny", _port_cfg(jcfg), lm)
    return {"topics": topics, "jbe": jbe, "tbe": tbe, "port": port,
            "jcfg": jcfg, "params": params, "lm": lm,
            "jQ": jax_queries(topics), "tQ": torch_queries(topics)}


def _rows(Q, idx):
    return {k: np.asarray(v)[idx] for k, v in Q.items()}


def _pipes(M):
    R, X = M.Retrieve, M.Extract
    return {"bm25": R("BM25") % 10,
            "fat": (R("BM25") >> (X("QL") ** X("DPH"))) % 10,
            "dense": (R("BM25", k=30) >> M.DenseRerank(alpha=0.3)) % 5}


def _serve(S, server_cls, pipes, be, Q, cfg=None, names=None):
    server = server_cls(pipes, be, cfg or S.ServeConfig.default())
    server.warmup(Q)
    out = {}
    for name in names or pipes:
        reqs = server.submit(_rows(Q, slice(None)), pipeline=name)
        server.pump()
        res = [r.wait(30) for r in reqs]
        out[name] = {k: np.concatenate([r[k] for r in res])
                     for k in res[0]}
    return server, out


@pytest.mark.parametrize("name", ["bm25", "fat", "dense"])
def test_served_rankings_equal_offline_and_reference(env, name):
    _, got = _serve(TS, TS.MultiPipelineServer, _pipes(rt), env["tbe"],
                    env["tQ"], names=[name])
    _, want = _serve(JS, JS.MultiPipelineServer, _pipes(J), env["jbe"],
                     env["jQ"], names=[name])
    got, want = got[name], want[name]
    off = rt.run_pipeline(_pipes(rt)[name], env["tQ"], backend=env["tbe"])
    np.testing.assert_array_equal(got["qid"], env["tQ"]["qid"].numpy())
    if name != "dense":
        np.testing.assert_array_equal(got["docids"], off["docids"].numpy())
        np.testing.assert_array_equal(got["scores"].view(np.int32),
                                      off["scores"].numpy().view(np.int32))
    else:
        assert_ranking_parity(off["docids"].numpy(), off["scores"].numpy(),
                              got["docids"], got["scores"], what="dense")
    assert_ranking_parity(want["docids"], want["scores"], got["docids"],
                          got["scores"], what=f"{name} vs JAX server")
    if "features" in want:
        np.testing.assert_array_equal(got["features"],
                                      off["features"].numpy())
        np.testing.assert_allclose(got["features"], want["features"],
                                   rtol=2e-5, atol=1e-5)


def _two_tenant(S, M, be, Q):
    """The reference's cross-prefix script (tests/test_serve_policy.py):
    two pipelines sharing ``Retrieve("BM25", k=20)``."""
    server = S.PipelineServer(M.Retrieve("BM25", k=20) >> M.Extract("QL"),
                              be, S.ServeConfig.default(optimize=False),
                              name="ql")
    server.add_pipeline(M.Retrieve("BM25", k=20) >> M.Extract("TF_IDF"),
                        name="tfidf")
    for i in range(4):
        server.submit_one(_rows(Q, slice(i, i + 1)))
    server.pump()
    reqs = [server.submit_one(_rows(Q, slice(i, i + 1)), pipeline="tfidf")
            for i in (2, 6, 3)]
    server.pump()
    res = [r.wait(30) for r in reqs]
    s = server.stats()
    trace = [(r.trace.cache_hit_depth, r.trace.cross_prefix_hit)
             for r in reqs]
    counts = (s["cross_pipeline_hits"], s["stage_cache"]["hits"],
              s["stage_cache"]["misses"],
              {n: p["cross_pipeline_prefix_hits"]
               for n, p in s["pipelines"].items()},
              {n: p["served"] for n, p in s["pipelines"].items()})
    return trace, counts, res


def test_two_tenant_cross_prefix_resume_counts_equal_reference(env):
    tt, tc, tres = _two_tenant(TS, rt, env["tbe"], env["tQ"])
    jt, jc, jres = _two_tenant(JS, J, env["jbe"], env["jQ"])
    assert tt == jt == [(1, True), (0, False), (1, True)]
    assert tc == jc
    assert tc[0] == 2
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a["docids"], np.asarray(b["docids"]))
        np.testing.assert_allclose(a["features"], np.asarray(b["features"]),
                                   rtol=2e-5, atol=1e-5)


def test_no_recompiles_after_warmup(env):
    be = env["port"]()
    server = TS.MultiPipelineServer(_pipes(rt), be,
                                    TS.ServeConfig.default(cache_entries=0))
    warm = server.warmup(env["tQ"])
    assert warm["compiles"] == be.engine.total_compiles() > 0
    rng = np.random.default_rng(0)
    n = 0
    while n < 100:
        burst = int(rng.integers(1, 40))
        idx = rng.integers(0, 8, burst)
        server.submit(_rows(env["tQ"], idx),
                      pipeline=("bm25", "fat", "dense")[n % 3])
        server.pump()
        n += burst
    s = server.stats()
    assert s["served"] == n
    assert s["recompiles_since_warmup"] == 0
    assert s["engine"]["max_compiles_per_stage"] <= len(be.engine.ladder)


def _rag(M, T=5):
    return (M.Retrieve("BM25") >> M.DenseRerank() % 8
            >> M.Generate("tiny", max_new_tokens=T, max_prompt_len=24,
                          prompt_docs=2))


def test_rag_tenant_tokens_equal_offline_and_reference(env):
    cfg = TS.ServeConfig.default().with_decode(3)
    tsrv, got = _serve(TS, TS.MultiPipelineServer,
                       {"ql": rt.Retrieve("BM25") % 10, "rag": _rag(rt)},
                       env["tbe"], env["tQ"], cfg)
    _, want = _serve(JS, JS.MultiPipelineServer,
                     {"ql": J.Retrieve("BM25") % 10, "rag": _rag(J)},
                     env["jbe"], env["jQ"], JS.ServeConfig.default()
                     .with_decode(3))
    s = tsrv.stats()
    assert s["recompiles_since_warmup"] == 0
    pool = s["decode_pools"]["rag"]
    assert pool["slots"] == 3 and pool["decode_steps"] > 0
    # the pool's two programs were captured once each, at warm-up
    assert tsrv.engine.compiles_by_cause()["pinned"] == 2
    off = rt.run_pipeline(_rag(rt), env["tQ"], backend=env["tbe"])
    assert got["rag"]["tokens"].shape == (8, 5)
    np.testing.assert_array_equal(got["rag"]["tokens"], off["tokens"].numpy())
    np.testing.assert_array_equal(got["rag"]["tokens"],
                                  np.asarray(want["rag"]["tokens"]))
    np.testing.assert_array_equal(got["rag"]["docids"],
                                  off["docids"].numpy())


def test_rag_tenants_sharing_a_generate_stage_keep_their_caches(env):
    """Two generate tenants whose Generate stages are equal, behind
    different retrievers: each decode pool owns its KV cache, so each
    takes pinned programs of its own, and with both pools decoding at
    once each tenant's tokens equal its offline pipeline's."""
    be = env["port"]()
    be.register_lm("tiny", _port_cfg(env["jcfg"]), env["lm"])

    def rag(first):
        return (first >> rt.DenseRerank() % 8
                >> rt.Generate("tiny", max_new_tokens=5, max_prompt_len=24,
                               prompt_docs=2))

    pipes = {"bm25": rag(rt.Retrieve("BM25")),
             "ql": rag(rt.Retrieve("QL", k=30))}
    server = TS.MultiPipelineServer(pipes, be,
                                    TS.ServeConfig.default().with_decode(3))
    server.warmup(env["tQ"])
    reqs = {name: server.submit(_rows(env["tQ"], slice(None)), pipeline=name)
            for name in pipes}
    server.pump()
    assert server.stats()["recompiles_since_warmup"] == 0
    assert be.engine.compiles_by_cause()["pinned"] == 4
    for name, pipe in pipes.items():
        got = np.concatenate([r.wait(30)["tokens"] for r in reqs[name]])
        off = rt.run_pipeline(pipe, env["tQ"], backend=be)
        np.testing.assert_array_equal(got, off["tokens"].numpy(), name)


def test_ragged_decode_equals_reference(env):
    """The port's ragged step against the JAX package's ``_ragged_decode``
    on the same cache and per-slot positions (float32, 1e-4), and against
    the port's one-position step where every slot is at one position."""
    jcfg, tcfg = env["jcfg"], _port_cfg(env["jcfg"])
    rng = np.random.default_rng(0)
    B, L = 3, 20
    shape = (tcfg.n_layers, B, L, tcfg.n_kv, tcfg.d_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(2, tcfg.vocab, (B, 1)).astype(np.int32)
    pos = np.array([4, 11, 0], np.int32)
    jl, jc = jbatching._ragged_decode(
        jcfg, env["params"], jnp.asarray(tokens),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(pos))
    cache = {"k": torch.tensor(k), "v": torch.tensor(v)}
    with torch.no_grad():
        tl, tc = TT.decode_step_ragged(tcfg, env["lm"], torch.tensor(tokens),
                                       cache, torch.tensor(pos))
    assert tc is cache                                  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=1e-5)
    same = torch.full((B,), 7, dtype=torch.int32)
    c1 = {n: torch.tensor(a) for n, a in (("k", k), ("v", v))}
    c2 = {n: torch.tensor(a) for n, a in (("k", k), ("v", v))}
    with torch.no_grad():
        a, _ = TT.decode_step_ragged(tcfg, env["lm"], torch.tensor(tokens),
                                     c1, same)
        b, _ = TT.decode_step(tcfg, env["lm"], torch.tensor(tokens), c2, 7)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c1["k"][:, :, :8], c2["k"][:, :, :8])


def test_pool_through_engine_equals_eager_pool(env):
    tcfg, lm = _port_cfg(env["jcfg"]), env["lm"]
    eng = rt.ShardedQueryEngine("cpu")
    pools = [ContinuousBatcher(tcfg, lm, slots=2, max_len=20, engine=e,
                               key=("pool",) if e else None)
             for e in (eng, None)]
    rng = np.random.default_rng(1)
    prompts = rng.integers(2, tcfg.vocab, (5, 12)).astype(np.int32)
    for p in pools:
        for i in range(5):
            p.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=4 + i))
    done = [{r.rid: r.generated for r in p.run_to_completion()}
            for p in pools]
    assert done[0] == done[1] and len(done[0]) == 5
    # the last request stops at the cache's end (12 + 7 < max_len - 1)
    assert [len(done[0][i]) for i in range(5)] == [4, 5, 6, 7, 8]
    assert eng.compiles_by_cause()["pinned"] == 2
    assert pools[0].n_decode_steps == pools[1].n_decode_steps


def _moe_lm(reduced, seed):
    """(JAX cfg in float32, its params, the port's cfg, the port's LM)."""
    import dataclasses
    jcfg = dataclasses.replace(reduced()[0], dtype=jnp.float32, remat=False)
    params, lm = _carry(jcfg, seed=seed)
    return jcfg, params, _port_cfg(jcfg), lm


def _pool_tokens(pool, prompts, new):
    for i, p in enumerate(prompts):
        pool.submit(Request(rid=i, prompt=p, max_new_tokens=new[i]))
    return {r.rid: r.generated for r in pool.run_to_completion()}


def test_moe_pool_equals_reference_pool():
    """An olmoe-smoke pool of 3 slots against the JAX pool over one request
    sequence: each step routes all 3 slots, idle ones included, on both
    sides, so the tokens are equal (float32)."""
    from repro.configs import olmoe_1b_7b as jolmoe
    jcfg, params, tcfg, lm = _moe_lm(jolmoe.reduced, 4)
    rng = np.random.default_rng(2)
    prompts = rng.integers(2, tcfg.vocab, (5, 12)).astype(np.int32)
    new = [3, 7, 5, 4, 6]
    want = _pool_tokens(jbatching.ContinuousBatcher(jcfg, params, slots=3,
                                                    max_len=24), prompts, new)
    eng = rt.ShardedQueryEngine("cpu")
    for engine in (None, eng):
        got = _pool_tokens(ContinuousBatcher(
            tcfg, lm, slots=3, max_len=24, engine=engine,
            key=("moe",) if engine else None), prompts, new)
        assert got == want and [len(got[i]) for i in range(5)] == new


def test_chunked_pool_equals_generate_past_the_chunk():
    """The recorded deviation (ROADMAP §3): llama4-smoke's decode steps at
    positions 12-23 cross its chunk boundary at 16.  The port's 1-slot pool
    gives the tokens of ``Generate``'s decode at batch 1, and its ragged
    step the logits of the one-position step; the JAX package's ragged
    step drops the chunk, so its logits past the boundary differ from its
    own ``decode_step``'s."""
    from repro.configs import llama4_scout_17b_a16e as jllama4
    from repro.models import transformer_lm as JT
    from repro_torch.core.stages import greedy_generate_fn
    jcfg, params, tcfg, lm = _moe_lm(jllama4.reduced, 5)
    prompt = np.random.default_rng(3).integers(2, tcfg.vocab, (1, 12)).astype(
        np.int32)
    want = greedy_generate_fn(tcfg, max_prompt_len=12, max_new_tokens=12)(
        lm, torch.tensor(prompt))
    got = _pool_tokens(ContinuousBatcher(tcfg, lm, slots=1, max_len=40),
                       prompt, [12])
    assert got[0] == want[0].tolist()
    # one step at position 20 (chunk 16-31) over a cache of random rows
    rng = np.random.default_rng(4)
    shape = (tcfg.n_layers, 1, 40, tcfg.n_kv, tcfg.d_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tok, pos = np.array([[7]], np.int32), 20

    def cache(lib):
        return {"k": lib(k.copy()), "v": lib(v.copy())}

    with torch.no_grad():
        ragged = TT.decode_step_ragged(tcfg, lm, torch.tensor(tok),
                                       cache(torch.tensor),
                                       torch.tensor([pos]))[0]
        step = TT.decode_step(tcfg, lm, torch.tensor(tok),
                              cache(torch.tensor), pos)[0]
    torch.testing.assert_close(ragged, step, rtol=1e-5, atol=1e-5)
    jstep = JT.decode_step(jcfg, params, jnp.asarray(tok), cache(jnp.asarray),
                           pos)[0]
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=1e-4,
                               atol=1e-4)
    jragged = jbatching._ragged_decode(jcfg, params, jnp.asarray(tok),
                                       cache(jnp.asarray),
                                       jnp.asarray([pos], jnp.int32))[0]
    assert np.abs(np.asarray(jragged) - np.asarray(jstep)).max() > 1e-2


def _recorder_script(S, M, be, Q, clock):
    server = S.PipelineServer(M.Retrieve("BM25") % 10, be,
                              S.ServeConfig.default().with_observability())
    for i in range(3):
        server.submit_one(_rows(Q, slice(i, i + 1)))
    server.pump()
    for _ in range(8):
        server.scheduler.note_service_time(0.2, 8)
    with pytest.raises(S.DeadlineUnmeetable):
        server.submit_one(_rows(Q, slice(3, 4)), timeout_ms=10.0)
    server.submit_one(_rows(Q, slice(4, 5)), timeout_ms=500.0)
    server.submit_one(_rows(Q, slice(5, 6)), timeout_ms=None)
    clock.sleep(0.6)
    server.pump()
    return server, server.flight_record()


def test_flight_recorder_event_kinds_in_reference_order(env, clock):
    # the ladder of the reference server without an engine
    tsrv, tev = _recorder_script(TS, rt, env["port"](bucket_ladder=(1, 2, 4, 8, 16)),
                                 env["tQ"], clock)
    _, jev = _recorder_script(JS, J, env["jbe"], env["jQ"], clock)
    # the reference's sequential backend has no engine, so no compile
    # events; the port's engine records each program-cache entry
    kinds = [e["kind"] for e in tev if e["kind"] != "recompile"]
    assert kinds == [e["kind"] for e in jev]
    assert {"admit", "batch_close", "shed_door", "shed_queue"} <= set(kinds)
    made = [e for e in tev if e["kind"] == "recompile"]
    assert made and all(e["cause"] in ("cold_rung", "ladder_miss")
                        for e in made)
    assert len(made) == tsrv.engine.total_compiles()
    out = tsrv.trace_export()
    names = {e["name"] for e in out["traceEvents"]}
    assert {"serve.request", "engine.dispatch",
            "engine.jit_compile"} <= names
    assert "engine_compiles_total" in tsrv.metrics_snapshot()
    assert "serve_requests_total" in tsrv.metrics_text()


def test_serve_names_exported_under_the_reference_names():
    for name in ("PipelineServer", "MultiPipelineServer", "ServeConfig",
                 "DeadlineUnmeetable", "StageResultCache",
                 "ShardedQueryEngine"):
        assert getattr(rt, name).__name__ == name
    assert TS.PipelineServer is rt.PipelineServer
    assert rt.ServeConfig.default().as_dict() == \
        JS.ServeConfig.default().as_dict()
