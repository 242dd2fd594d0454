"""The port's tracer (``obs/tracing.py``): the disabled path allocates
nothing; while ``torch.profiler`` records, every context-manager span is a
profiler range of the same name at each layer of an Experiment call, with
no tracer and no descriptor opted in; an enabled tracer's records lie on
the profiler's clock; ``begin()`` spans are not mirrored."""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch as rt
from repro_torch.index.corpus import synthesize_corpus, synthesize_topics
from repro_torch.models.transformer_lm import LMConfig
from repro_torch.obs.tracing import NOOP_SPAN, NOOP_TRACER, Tracer, set_tracer

#: a span and the span it must lie inside
PARENT = {"plan.build": "experiment.call", "plan.execute": "experiment.call",
          "experiment.measures": "experiment.call",
          "plan.stage": "plan.execute", "engine.dispatch": "plan.stage",
          "sparse.gather": "engine.dispatch",
          "sparse.scatter": "engine.dispatch",
          "generate.assemble": "plan.stage", "generate.lm": "plan.stage"}


@pytest.fixture(scope="module")
def env():
    corpus = synthesize_corpus(n_docs=400, vocab=3000, mean_len=40, seed=1)
    topics = synthesize_topics(corpus, n_topics=6, q_len=3, rels_per_topic=5,
                               seed=2)
    index = rt.build_index(corpus, device="cpu")
    Q = rt.make_queries(topics.terms, topics.weights, topics.qids,
                        device="cpu")
    return {"index": index, "topics": topics, "Q": Q}


def _backend(env, observability=False):
    desc = rt.BackendDescriptor.default(device="cpu")
    return rt.TorchBackend(env["index"], default_k=20, query_chunk=4,
                           device="cpu",
                           descriptor=desc.with_observability(observability))


def _ranges(prof) -> dict:
    """Host ranges of a finished profile by name: [(start_ns, end_ns,
    thread)] in order of start."""
    out: dict = {}
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.start_thread_id()))
    return {k: sorted(v) for k, v in out.items()}


def _experiment(env, be, pipe):
    return rt.Experiment([pipe], env["Q"], env["topics"].qrels, ["map"],
                         backend=be)


def _assert_nested(ranges, names):
    for name in names:
        assert ranges.get(name), f"no {name} range"
        parent = PARENT.get(name)
        if parent is None:
            continue
        for s, e, tid in ranges[name]:
            assert any(ps <= s and e <= pe and pt == tid
                       for ps, pe, pt in ranges[parent]), \
                f"a {name} range lies outside every {parent} range"


def test_disabled_span_is_the_shared_noop():
    tracer = Tracer(enabled=False)
    assert NOOP_TRACER.span("x.y", "cat", a=1) is NOOP_SPAN
    with tracer.span("x.y") as sp:
        assert sp is NOOP_SPAN
        sp.set(b=2)
    assert tracer.begin("x.z") is NOOP_SPAN
    assert len(tracer) == 0 and tracer.records() == []


def test_experiment_layers_reach_the_profiler(env):
    """No tracer, no descriptor opted in: the profiler sees every layer's
    span, each inside its parent."""
    set_tracer(None)
    be = _backend(env)
    pipe = rt.Retrieve("BM25") >> (rt.Extract("QL") ** rt.Extract("TF_IDF"))
    _experiment(env, be, pipe)                    # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _experiment(env, be, pipe)
    ranges = _ranges(prof)
    _assert_nested(ranges, ["experiment.call", "plan.build", "plan.execute",
                            "plan.stage", "engine.dispatch", "sparse.gather",
                            "sparse.scatter", "experiment.measures"])
    assert len(ranges["experiment.call"]) == 1
    assert any(n.startswith("compile.pass.") for n in ranges)


def test_rag_generate_spans_reach_the_profiler(env):
    be = _backend(env)
    cfg = LMConfig(name="t", n_layers=1, d_model=32, n_q=4, n_kv=2, d_head=8,
                   d_ff=64, vocab=128, dtype=torch.float32,
                   attn_impl="pallas")
    be.register_lm("t", cfg)
    rag = (rt.Retrieve("BM25") >> rt.DenseRerank() % 4
           >> rt.Generate("t", max_new_tokens=3, max_prompt_len=16,
                          prompt_docs=2))
    _experiment(env, be, rag)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _experiment(env, be, rag)
    _assert_nested(_ranges(prof), ["experiment.call", "plan.stage",
                                   "generate.assemble", "generate.lm"])


def test_records_lie_on_the_profiler_clock(env, tmp_path):
    """An enabled tracer with an opted-in descriptor: each record starts and
    ends within 100 us of the profiler's range of the same span, and the
    export lines up with the profiler's own export."""
    tracer = set_tracer(Tracer(enabled=True))
    try:
        be = _backend(env, observability=True)
        pipe = rt.Retrieve("BM25") % 10
        _experiment(env, be, pipe)
        tracer.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _experiment(env, be, pipe)
        recs = tracer.records()
        exported = tracer.export_chrome()["traceEvents"]
    finally:
        set_tracer(None)
    ranges = _ranges(prof)
    names = {r["name"] for r in recs}
    assert {"experiment.call", "plan.build", "plan.execute", "plan.stage",
            "experiment.measures", "compile.pipeline"} <= names
    for name in names:
        mine = sorted((r for r in recs if r["name"] == name),
                      key=lambda r: r["t0"])
        theirs = ranges[name]
        assert len(mine) == len(theirs), name
        for r, (s, e, _) in zip(mine, theirs):
            assert abs(tracer.profiler_ns(r["t0"]) - s) < 100_000, name
            assert abs(tracer.profiler_ns(r["t1"]) - e) < 100_000, name
    call = next(ev for ev in exported if ev["name"] == "experiment.call")
    assert abs(call["ts"] * 1e3 - ranges["experiment.call"][0][0]) < 100_000
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    theirs = json.loads((tmp_path / "prof.json").read_text())
    base = int(theirs.get("baseTimeNanoseconds", 0))
    ts = next(ev["ts"] for ev in theirs["traceEvents"]
              if ev.get("name") == "experiment.call")
    mine = next(ev["ts"] for ev in tracer.export_chrome(base)["traceEvents"]
                if ev["name"] == "experiment.call")
    assert abs(mine - ts) < 100


def test_the_clock_offset_is_read_at_each_use(monkeypatch):
    """The realtime clock is slewed against the monotonic one over a
    long-lived tracer's life: the offset follows it, and each export takes
    it anew."""
    tracer = Tracer(enabled=True)
    with tracer.span("t"):
        pass
    before = tracer.export_chrome()["traceEvents"][0]["ts"]
    real = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: real() + 5_000_000)
    after = tracer.export_chrome()["traceEvents"][0]["ts"]
    assert abs(after - before - 5_000) < 100


def test_begin_spans_are_not_mirrored():
    tracer = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracer.begin("manual.begin").end()
        tracer.add_span("manual.added", 0.0, 1e-3)
        tracer.event("manual.event")
        with tracer.span("manual.live"):
            pass
    assert {r["name"] for r in tracer.records()} == {
        "manual.begin", "manual.added", "manual.event", "manual.live"}
    ranges = _ranges(prof)
    assert "manual.live" in ranges
    assert not {"manual.begin", "manual.added", "manual.event"} & set(ranges)
