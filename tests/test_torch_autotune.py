"""The port's backend-aware optimiser: the op-stream cost model
(``analysis/op_cost.py``), the cost-gated ``FusionPass`` and the measured
``AutotunePass`` (``core/passes.py``), the persisted ``TuningProfile`` and
the descriptor's peaks (``core/descriptor.py``), on the tests/conftest.py
corpus, held against the JAX package where it gives a result: the
profile's keys and files, the peak fit, and the static gate's decisions on
the same pipelines.  Modelled on tests/test_descriptor.py.  Measurements
here are CPU wall clocks of the plain versions (the gate's policy only);
on the card the gate times with CUDA events."""
import json

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.analysis import hlo_cost
from repro.core.compiler import JaxBackend
from repro.core.descriptor import TuningProfile as JTuningProfile
from repro.index.inverted import build_index as jbuild
from repro_torch.analysis import op_cost
from repro_torch.core import passes as TP
from repro_torch.core.compiler import TorchBackend
from repro_torch.core.descriptor import BackendDescriptor, TuningProfile
from repro_torch.index import dense as TD
from repro_torch.index.inverted import build_index as tbuild

from torch_parity import small_env, torch_queries

#: fusion-visible capability set (pruned_topk off: the pushdown rewrite
#: would otherwise consume the cutoff before the gate ever sees it)
FUSE_CAPS = frozenset({"fat", "fused_topk", "fused_scoring", "multi_model"})
ALL_CAPS = FUSE_CAPS | {"fused_dense", "dense_topk", "pq_topk"}
N_LISTS = 16


@pytest.fixture(scope="module")
def env():
    corpus, topics, _ = small_env()
    jidx = jbuild(corpus)
    jbe = JaxBackend(jidx, default_k=60, query_chunk=4, sharded=False)
    return {"tidx": tbuild(corpus, device="cpu"), "jidx": jidx,
            "jdense": jbe.dense,
            "tdense": TD.dense_from_arrays(np.asarray(jbe.dense.emb), "cpu"),
            "topics": topics, "Q": torch_queries(topics)}


def _backend(env, profile=None, *, autotune=True, band=10.0, default_k=50,
             caps=FUSE_CAPS, **kw):
    desc = BackendDescriptor.default(caps).with_profile(profile)
    if autotune:
        desc = desc.with_autotune(True, band=band, probe_queries=2,
                                  probe_repeats=1)
    return TorchBackend(env["tidx"], env["tdense"], default_k=default_k,
                        device="cpu", descriptor=desc, ivf_lists=N_LISTS,
                        pq_m=8, **kw)


def _compile(backend, pipe=None):
    rep = {}
    op = T.compile_pipeline(pipe if pipe is not None
                            else T.Retrieve("BM25", k=50) % 10,
                            backend, report=rep)
    return op, rep


# ---------------------------------------------------------------------------
# the tuning profile, against the reference's class
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op_key,bucket", [
    (("topk", ("topk_fused", "BM25", 10, 400), ("topk_unfused",)), 8),
    (("nprobe_tune", "nprobe", (4, 8, 16), (True, 10, 4)), 8),
    ("plain", 3)])
def test_profile_key_equals_reference(op_key, bucket):
    assert TuningProfile.key("digest", op_key, bucket) == \
        JTuningProfile.key("digest", op_key, bucket)


def test_profile_save_roundtrips_like_reference(tmp_path):
    decision = {"accepted": True, "source": "measured",
                "fused_key": ("topk_fused", "BM25", 10, 400)}
    files = []
    for cls in (TuningProfile, JTuningProfile):
        path = tmp_path / f"{cls.__module__}.json"
        prof = cls(path)
        prof.record("digest", ("topk", ("f",), ("u",)), 8, decision)
        prof.note_calibration({"peak_flops_per_s": 2e13,
                               "peak_bytes_per_s": 4e11})
        assert prof.dirty
        prof.save()
        assert not prof.dirty and path.exists()
        again = cls(path)
        hit = again.lookup("digest", ("topk", ("f",), ("u",)), 8)
        assert hit == json.loads(json.dumps(decision))
        assert again.lookup("digest", ("other",), 8) is None
        assert again.info()["hits"] == 1 and again.info()["misses"] == 1
        files.append(json.loads(path.read_text()))
    assert files[0] == files[1]


@pytest.mark.parametrize("text", [
    '{"version": 1, "entries": {"x": ',                  # truncated
    json.dumps({"version": 999, "entries": {}}),          # wrong version
    json.dumps({"version": 1, "entries": [1, 2]})],       # not a mapping
    ids=["truncated", "version", "entries"])
def test_profile_corrupt_file_recovery_like_reference(tmp_path, text):
    for cls in (TuningProfile, JTuningProfile):
        path = tmp_path / "profile.json"
        path.write_text(text)
        prof = cls(path)
        assert prof.entries == {} and prof.calibration is None
        assert not path.exists()


# ---------------------------------------------------------------------------
# the peak fit, against hlo_cost's
# ---------------------------------------------------------------------------

def _synthetic_records(n=6, g_true=100.0, pf_true=2.0e13, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        rec = {}
        for side in ("unfused", "fused"):
            F = float(rng.uniform(1e6, 1e9))
            B = float(rng.uniform(1e5, 1e8))
            rec[side] = {"flops": F, "bytes": B,
                         "measured_s": (F + g_true * B) / pf_true}
        recs.append(rec)
    return recs


def test_fit_peaks_equals_reference_and_recovers_roofline():
    recs = _synthetic_records()
    fit = op_cost.fit_peaks(recs)
    assert fit == hlo_cost.fit_peaks(recs)
    assert fit["n_records"] == 6
    assert abs(np.log10(fit["gamma"] / 100.0)) < 1e-6
    assert abs(fit["peak_flops_per_s"] / 2.0e13 - 1) < 1e-6
    assert fit["rms_log_ratio_error"] < 1e-9
    noisy = _synthetic_records(seed=3)
    noisy[2]["fused"]["measured_s"] *= 1.7
    assert op_cost.fit_peaks(noisy) == hlo_cost.fit_peaks(noisy)


@pytest.mark.parametrize("records", [
    [],
    [{"unfused": {"flops": 0, "bytes": 1, "measured_s": 1},
      "fused": {"flops": 1, "bytes": 1, "measured_s": 1}}],
    [{"unfused": {"flops": 1, "bytes": 1}, "fused": None}]],
    ids=["none", "zero-flops", "unmeasured"])
def test_fit_peaks_rejects_unusable_records_like_reference(records):
    assert op_cost.fit_peaks(records) is None
    assert hlo_cost.fit_peaks(records) is None


def test_calibration_records_equal_reference():
    rec = _synthetic_records(n=1)[0]
    summary = {"fusion": {"workloads": {"a": {"calibration": rec},
                                        "b": {}}},
               "autotune": {"workloads": {"c": {"calibration": rec}}},
               "dense": None, "other": {"workloads": {"d": {
                   "calibration": rec}}}}
    got = op_cost.calibration_records(summary)
    assert got == hlo_cost.calibration_records(summary) and len(got) == 2


# ---------------------------------------------------------------------------
# the op-stream counts
# ---------------------------------------------------------------------------

def _count(fn):
    with torch.no_grad(), op_cost.OpCounter() as c:
        fn()
    return c.flops, c.bytes


def test_hand_counts_of_a_matmul_gather_scatter_and_elementwise_op():
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    # dot: 2 * out * K flops; operands + result bytes
    assert _count(lambda: a @ b) == (2 * 12 * 8, 4 * (32 + 24 + 12))
    x, i = torch.randn(100), torch.tensor([1, 2, 3, 7])
    # gather: 1 flop an output element; 2 * result + index bytes
    assert _count(lambda: x[i]) == (4, 2 * 16 + 32)
    assert _count(lambda: torch.gather(x[None], 1, i[None])) == (4, 32 + 32)
    d, upd = torch.zeros(100), torch.ones(4)
    # scatter: result + 3 * updates bytes
    assert _count(lambda: d.index_add_(0, i, upd)) == (100, 400 + 3 * 16)
    # elementwise: 1 flop an output element; operands + result bytes
    y = torch.randn(10, 10)
    assert _count(lambda: y * y) == (100, 3 * 400)
    # views and allocations are free
    assert _count(lambda: (y.view(100)[3:], y.t(), torch.empty(50),
                           torch.arange(9))) == (0, 0)


def test_kernel_entries_price_their_formula_not_their_plain_version():
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    from repro_torch.kernels.fused_scoring.ops import MODEL_OPS, fused_scoring
    from repro_torch.kernels.pq_scoring.ops import streaming_pq_topk
    from repro_torch.kernels.topk.ops import streaming_topk
    from repro_torch.kernels.topk.ref import streaming_topk_ref
    g = torch.Generator().manual_seed(0)
    s = torch.randn(3, 500, generator=g)
    assert _count(lambda: streaming_topk(s, k=7)) == (3 * 500,
                                                       3 * 500 * 4 + 3 * 7 * 8)
    # the plain version alone costs more than the formula (a full sort)
    assert _count(lambda: streaming_topk_ref(s, k=7))[1] > 3 * 500 * 4
    # under the counter nothing is computed: zeros of the kernel's output
    # shapes and dtypes come back, on the input's device
    with op_cost.OpCounter():
        v, i = streaming_topk(s, k=7)
        v1, i1 = streaming_topk(s[0], k=7)
    assert torch.equal(v, torch.zeros(3, 7)) and i.dtype == torch.int32
    assert torch.equal(i, torch.zeros(3, 7, dtype=torch.int32))
    assert v1.shape == i1.shape == (7,)
    with op_cost.OpCounter(), pytest.raises(ValueError):
        streaming_topk(s, k=501)
    emb, q = torch.randn(400, 16, generator=g), torch.randn(2, 16, generator=g)
    base = torch.randn(2, 400, generator=g)
    assert _count(lambda: streaming_dense_topk(emb, q, k=5)) == (
        2 * 2 * 400 * 16, 4 * (400 * 16 + 2 * 16) + 2 * 5 * 8)
    emb3 = torch.randn(2, 400, 16, generator=g)
    assert _count(lambda: streaming_dense_topk(emb3, q, base, k=5)) == (
        2 * 2 * 400 * 16, 4 * (2 * 400 * 16 + 2 * 16 + 2 * 400) + 2 * 5 * 8)
    codes = torch.randint(0, 256, (2, 300, 8), generator=g, dtype=torch.uint8)
    table = torch.randn(2, 8, 256, generator=g)
    assert _count(lambda: streaming_pq_topk(codes, table, base[:, :300],
                                            k=9, block=64)) == (
        2 * 300 * 8, 2 * 300 * 8 + 4 * 2 * 8 * 256 + 4 * 600 + 2 * 9 * 8)
    tf = torch.randint(0, 5, (2, 3, 40), generator=g, dtype=torch.int32)
    dl = torch.randint(1, 90, (2, 3, 40), generator=g, dtype=torch.int32)
    df = torch.randint(1, 9, (2, 3, 1), generator=g, dtype=torch.int32)
    cf = df * 3
    stats = {"n_docs": 100, "avg_doclen": 30.0, "total_terms": 3000}
    models = ("BM25", "QL", "TF_IDF")
    n = tf.numel()
    assert _count(lambda: fused_scoring(tf, dl, df, cf, models=models,
                                        stats=stats)) == (
        n * (12 + 12 + 8), n * 8 + 6 * 8 + n * 3 * 4)
    with op_cost.OpCounter():
        outs = [streaming_dense_topk(emb3, q, base, k=5),
                streaming_pq_topk(codes, table, None, k=9),
                (fused_scoring(tf, dl, df, cf, models=models, stats=stats),)]
    assert [tuple(x.shape) for o in outs for x in o] == [
        (2, 5), (2, 5), (2, 9), (2, 9), (2, 3, 40, 3)]
    assert all(not x.any() for o in outs for x in o)
    assert sum(MODEL_OPS[m] for m in models) == 32


def test_estimate_is_device_scoped_and_on_the_datasheet_peaks():
    d = BackendDescriptor.default()
    assert (d.peak_flops_per_s, d.peak_bytes_per_s) == (67.0e12, 3.35e12)
    assert d.host == op_cost.host_fingerprint("cpu")
    assert len(d.peak_digest) == 16
    d2 = d.calibrated({"peak_flops_per_s": 2.0e13,
                       "peak_bytes_per_s": 4.0e11})
    assert d2.peak_digest != d.peak_digest


# ---------------------------------------------------------------------------
# the static gate on the five patterns, against the JAX package's
# ---------------------------------------------------------------------------

def _gate_pipelines(M):
    return {
        "topk": M.Retrieve("BM25") % 10,
        "fat": (M.Retrieve("BM25") >> (M.Extract("QL")
                                       ** M.Extract("TF_IDF"))) % 10,
        "dense_topk": M.DenseRetrieve(k=200, nprobe=0) % 10,
        "dense_rerank": (M.Retrieve("BM25", k=200)
                         >> M.DenseRerank(alpha=0.3)) % 10,
        "pq_topk": M.DenseRetrieve(k=10, nprobe=8, pq=True) % 10}


#: where the JAX package's static HLO gate keeps the chain, and why: for
#: fat, off a TPU its Pallas fused-scoring kernel lowers to more HLO
#: traffic than XLA's fused unfused chain, so it prices dearer; for IVF-PQ
#: at k_in == K its two candidates lower to the same HLO cost (the fused
#: one at an explicit shortlist equal to the default), a tie that strict
#: less-than rejects.  The port prices each kernel by its formula (what the
#: card runs) against the eager chain, which materialises the score rows
#: and sorts them, so it takes both
JAX_KEEPS = {"fat": "dearer", "pq_topk": "tie"}


@pytest.fixture(scope="module")
def gate_backends(env):
    jkw = dict(default_k=60, query_chunk=4, sharded=False, ivf_lists=N_LISTS,
               pq_m=8)
    jbe = JaxBackend(env["jidx"], dense=env["jdense"],
                     descriptor=J.BackendDescriptor.default(ALL_CAPS), **jkw)
    tbe = _backend(env, autotune=False, default_k=60, caps=ALL_CAPS)
    return jbe, tbe


@pytest.mark.parametrize("pattern", ["topk", "fat", "dense_topk",
                                     "dense_rerank", "pq_topk"])
def test_default_lowering_is_fused_on_estimates(gate_backends, pattern):
    jbe, tbe = gate_backends
    want = {"topk": "fused_topk_retrieve", "fat": "fused_fat_retrieve",
            "dense_topk": "fused_dense_retrieve",
            "dense_rerank": "fused_dense_rerank",
            "pq_topk": "fused_dense_retrieve"}[pattern]
    op, rep = _compile(tbe, _gate_pipelines(T)[pattern])
    assert op.kind == want
    (d,) = rep["fusion_decisions"]
    assert d["pattern"] == pattern and d["source"] == "estimate"
    assert d["accepted"] and d["fused_proxy_s"] < d["unfused_proxy_s"]
    assert d["fused_flops"] > 0 and d["unfused_bytes"] > d["fused_bytes"]
    jrep = {}
    J.compile_pipeline(_gate_pipelines(J)[pattern], jbe, report=jrep)
    (jd,) = jrep["fusion_decisions"]
    assert jd["pattern"] == pattern and jd["source"] == "estimate"
    assert jd["accepted"] == (pattern not in JAX_KEEPS)
    if JAX_KEEPS.get(pattern) == "tie":
        assert jd["fused_proxy_s"] == jd["unfused_proxy_s"]
    elif JAX_KEEPS.get(pattern) == "dearer":
        assert jd["fused_proxy_s"] > jd["unfused_proxy_s"]


#: peaks the default lowerings must fuse under: the datasheet's, three
#: fits cell A1 measured on an H100 (two at gamma 1.0, flop/s = B/s; one
#: at gamma 2.37), and both ends of fit_peaks's gamma grid at the
#: datasheet's flop rate
REFIT_PEAKS = [(67.0e12, 3.35e12), (1.94e11, 1.94e11), (1.70e11, 1.70e11),
               (2.584e11, 1.090e11), (67.0e12, 67.0e12), (67.0e12, 6.7e9)]


@pytest.mark.parametrize("pattern", ["topk", "fat", "dense_topk",
                                     "dense_rerank", "pq_topk", "g1"])
def test_default_lowerings_fuse_under_refitted_peaks(env, pattern):
    """Each fused candidate costs no more flops and strictly fewer bytes
    than the chain it replaces, so it prices cheaper under any positive
    peaks, however thin its margin: G1's dense_rerank (retrieve 1000,
    rerank to 8) included."""
    pipes = {**_gate_pipelines(T),
             "g1": T.Retrieve("BM25") >> T.DenseRerank() % 8}
    want = {"topk": "fused_topk_retrieve", "fat": "fused_fat_retrieve",
            "dense_topk": "fused_dense_retrieve",
            "dense_rerank": "fused_dense_rerank",
            "pq_topk": "fused_dense_retrieve",
            "g1": "fused_dense_rerank"}[pattern]
    be = _backend(env, autotune=False, default_k=1000, caps=ALL_CAPS)
    base = be.descriptor
    for pf, pb in REFIT_PEAKS:
        be.descriptor = base.calibrated({"peak_flops_per_s": pf,
                                         "peak_bytes_per_s": pb})
        op, rep = _compile(be, pipes[pattern])
        assert op.kind == want, (pf, pb)
        (d,) = rep["fusion_decisions"]
        assert d["source"] == "estimate" and d["accepted"], (pf, pb)
        assert d["fused_flops"] <= d["unfused_flops"]
        assert d["fused_bytes"] < d["unfused_bytes"]


def test_gate_estimates_are_cached_and_scoped_by_peak_digest(env):
    be = _backend(env, autotune=False)
    _, rep1 = _compile(be)
    assert rep1["tuning"]["gate_estimates"] == 2
    assert set(be._cost_estimates) == {be.descriptor.peak_digest}
    _, rep_again = _compile(be)
    assert rep_again["tuning"]["gate_estimates"] == 0
    be.descriptor = be.descriptor.calibrated(
        {"peak_flops_per_s": 3.3e13, "peak_bytes_per_s": 1.1e11})
    _, rep2 = _compile(be)
    assert rep2["tuning"]["gate_estimates"] == 2
    assert len(be._cost_estimates) == 2


def test_kernel_limit_and_estimate_failed_are_recorded(env, monkeypatch):
    be = _backend(env, autotune=False, default_k=300)
    op, rep = _compile(be, T.Retrieve("BM25", k=300) % 200)
    (d,) = rep["fusion_decisions"]
    assert op.kind == "cutoff" and d["source"] == "kernel_limit"
    assert not d["accepted"] and rep["tuning"]["gate_estimates"] == 0
    from repro_torch.index import retrieve as RT

    def broken(*a, **kw):
        raise RuntimeError("no lowering")
    monkeypatch.setattr(RT, "retrieve_topk_fused", broken)
    be2 = _backend(env, autotune=False)
    op, rep = _compile(be2)
    (d,) = rep["fusion_decisions"]
    assert op.kind == "cutoff" and not d["accepted"]
    assert d["source"] == "estimate_failed"
    assert "RuntimeError: no lowering" in d["error"]
    assert d["fused_proxy_s"] is None and d["unfused_proxy_s"] > 0
    assert "estimate_failed: RuntimeError: no lowering" in \
        T.explain_pipeline(T.Retrieve("BM25", k=50) % 10, be2)


# ---------------------------------------------------------------------------
# the tuning profile in the gate
# ---------------------------------------------------------------------------

def test_profile_roundtrip_zero_probe_measurements(env, tmp_path):
    path = tmp_path / "profile.json"
    _, cold = _compile(_backend(env, TuningProfile(path)))
    assert cold["tuning"]["probe_measurements"] > 0
    assert cold["tuning"]["gate_estimates"] > 0
    assert path.exists()
    # fresh backend + fresh profile object loading the persisted file:
    # the decision replays with zero estimates and zero probes
    _, warm = _compile(_backend(env, TuningProfile(path)))
    assert warm["tuning"]["probe_measurements"] == 0
    assert warm["tuning"]["gate_estimates"] == 0
    assert warm["tuning"]["profile_hits"] == \
        len(cold["fusion_decisions"]) > 0
    assert warm["tuning"]["profile_misses"] == 0
    assert [d["source"] for d in warm["fusion_decisions"]] == \
        ["profile"] * len(cold["fusion_decisions"])
    assert [d["accepted"] for d in warm["fusion_decisions"]] == \
        [d["accepted"] for d in cold["fusion_decisions"]]


def test_profile_invalidated_by_backend_digest_change(env, tmp_path):
    path = tmp_path / "profile.json"
    _compile(_backend(env, TuningProfile(path)))
    # another default_k -> another backend content digest -> the persisted
    # entries miss and the gate tunes again
    _, rep = _compile(_backend(env, TuningProfile(path), default_k=40),
                      T.Retrieve("BM25", k=50) % 10)
    assert rep["tuning"]["profile_hits"] == 0
    assert rep["tuning"]["profile_misses"] > 0
    assert rep["tuning"]["gate_estimates"] > 0


# ---------------------------------------------------------------------------
# the autotune policy
# ---------------------------------------------------------------------------

def test_autotune_band_zero_measures_nothing(env):
    _, rep = _compile(_backend(env, band=0.0))
    assert rep["tuning"]["probe_measurements"] == 0
    assert all(d["source"] == "estimate" for d in rep["fusion_decisions"])


def test_autotune_wide_band_measures_and_records(env):
    _, rep = _compile(_backend(env, band=10.0))
    assert rep["tuning"]["probe_measurements"] == 2
    (d,) = rep["fusion_decisions"]
    assert d["source"] == "measured"
    assert d["fused_measured_s"] > 0 and d["unfused_measured_s"] > 0
    assert d["accepted"] == (d["fused_measured_s"] < d["unfused_measured_s"])
    # the op counts ride along for calibration
    assert d["fused_flops"] > 0 and d["unfused_bytes"] > 0


@pytest.mark.parametrize("fused_faster", [True, False])
def test_mixed_k_linear_fusion_is_measured_only(env, monkeypatch,
                                                fused_faster):
    pipe = 0.5 * T.Retrieve("BM25", k=30) + 0.5 * T.Retrieve("QL", k=50)
    # the static gate never takes mixed-k (it changes the truncation)
    op_static, rep_static = _compile(_backend(env, autotune=False), pipe)
    assert op_static.kind == "linear"
    assert all(d["pattern"] != "multi_mixed"
               for d in rep_static["fusion_decisions"])
    # autotune: taken only on a measured win, at k = max(k_i); the
    # probe's clock is replaced so that both outcomes are forced
    seen = []

    def measure(fn, static_args, batched_args, repeats):
        out = fn(*static_args, *batched_args)
        multi = not isinstance(out[0], tuple)    # one (docids, scores)
        seen.append(multi)
        return 1.0 if multi == fused_faster else 2.0
    monkeypatch.setattr(TP, "_measure_callable", measure)
    op, rep = _compile(_backend(env), pipe)
    ds = [d for d in rep["fusion_decisions"] if d["pattern"] == "multi_mixed"]
    assert len(ds) == 1 and ds[0]["source"] == "measured"
    assert sorted(seen) == [False, True]
    assert ds[0]["accepted"] is fused_faster
    if fused_faster:
        assert op.kind == "multi_retrieve" and op.params["k"] == 50
    else:
        assert op.kind == "linear"


def test_nprobe_knob_measures_then_replays(env, monkeypatch):
    """AutotunePass probes the nprobe candidates (time + overlap band) on
    an accepted fused IVF stage and replays the persisted choice with zero
    probes.  The gate itself decides on estimates here, so that a CPU
    clock's noise cannot keep the stage unfused and leave no knob."""
    monkeypatch.setattr(TP.AutotunePass, "_decide", TP.FusionPass._decide)
    caps = frozenset({"fat", "fused_dense", "dense_topk", "pq_topk"})
    desc = (BackendDescriptor.default(caps)
            .with_autotune(True, probe_queries=2, probe_repeats=1)
            .with_profile(TuningProfile(path=None)))
    be = TorchBackend(env["tidx"], env["tdense"], default_k=200,
                      device="cpu", descriptor=desc, ivf_lists=N_LISTS,
                      pq_m=8)
    for pipe in (T.DenseRetrieve(k=10, nprobe=8, pq=True) % 10,
                 T.DenseRetrieve(k=10, nprobe=8) % 10):
        op1, rep1 = _compile(be, pipe)
        (d,) = [d for d in rep1["fusion_decisions"] if d.get("knob")]
        assert d["knob"] == "nprobe" and d["source"] == "measured"
        assert d["candidates"] == [4, 8, 16] and d["chosen"] in d["candidates"]
        assert set(d["overlap_at_k"]) == {"4", "8", "16"}
        assert d["overlap_at_k"]["16"] == 1.0
        eligible = [c for c in (4, 8, 16) if d["overlap_at_k"][str(c)] >= 0.75]
        assert d["chosen"] == min(
            eligible, key=lambda c: d["measured_knob_s"][str(c)])
        assert op1.params["nprobe"] == d["chosen"]
        # the PQ kernel's tile is tuned on the card only
        assert "pq_block" not in op1.params
        assert rep1["tuning"]["probe_measurements"] == 3
        assert f"autotune knob [nprobe_tune]: nprobe={d['chosen']} " \
            "(configured 8, candidates [4, 8, 16], profile)" in \
            T.explain_pipeline(pipe, be)
        op2, rep2 = _compile(be, pipe)
        assert op2.params == op1.params
        assert [d2["source"] for d2 in rep2["fusion_decisions"]] == \
            ["profile", "profile"]
        assert rep2["tuning"]["probe_measurements"] == 0
        assert rep2["tuning"]["gate_estimates"] == 0


def test_explain_shows_measured_vs_predicted(env):
    text = T.explain_pipeline(T.Retrieve("BM25", k=50) % 10, _backend(env))
    line = [ln for ln in text.splitlines() if "fusion gate" in ln][0]
    assert "predicted fused" in line and "measured fused" in line
    assert line.endswith("kernel_native=True, measured)")


# ---------------------------------------------------------------------------
# auto-refit: a profile-carried calibration applied by with_profile
# ---------------------------------------------------------------------------

FIT = {"peak_flops_per_s": 2.0e13, "peak_bytes_per_s": 4.0e11,
       "gamma": 50.0, "n_records": 6, "rms_log_ratio_error": 0.01}


def test_with_profile_auto_refits_from_calibration(tmp_path):
    path = tmp_path / "p.json"
    prof = TuningProfile(path)
    prof.note_calibration(FIT)
    prof.save()
    prof2 = TuningProfile(path)
    d = BackendDescriptor.default().with_profile(prof2)
    assert d.peak_flops_per_s == FIT["peak_flops_per_s"]
    assert d.peak_bytes_per_s == FIT["peak_bytes_per_s"]
    assert prof2.pending_fit(d.peak_digest) is None    # marked applied
    d2 = BackendDescriptor.default().with_profile(prof2)
    assert d2.peak_digest == d.peak_digest
    prof2.save()
    prof3 = TuningProfile(path)
    assert prof3.pending_fit(d.peak_digest) is None
    assert prof3.info()["calibrated"]


def test_with_profile_auto_refit_opt_out():
    prof = TuningProfile(path=None)
    prof.note_calibration(FIT)
    d = BackendDescriptor.default().with_profile(prof, auto_refit=False)
    assert d.peak_flops_per_s != FIT["peak_flops_per_s"]
    assert prof.pending_fit(d.peak_digest) == {
        k: float(v) for k, v in FIT.items()}
    prof.note_calibration(None)
    prof.note_calibration({"peak_flops_per_s": 1.0})   # no bytes peak
    assert prof.calibration["fit"] == FIT


@pytest.mark.parametrize("bad", [{"gamma": 1.0}, {"gamma": 1.0e4},
                                 {"rms_log_ratio_error": 0.5}])
def test_an_unidentified_or_poor_fit_is_not_applied(bad):
    fit = {**FIT, **bad}
    assert op_cost.fit_refusal(fit) is not None
    assert op_cost.fit_refusal(FIT) is None
    prof = TuningProfile(path=None)
    prof.note_calibration(fit)
    assert prof.calibration is None and not prof.dirty
    # nor one that a profile file already holds
    prof.calibration = {"fit": fit, "applied_digest": None}
    d = BackendDescriptor.default().with_profile(prof)
    assert (d.peak_flops_per_s, d.peak_bytes_per_s) == (67.0e12, 3.35e12)
    # an explicit calibration is the caller's to make
    assert d.calibrated(fit).peak_flops_per_s == fit["peak_flops_per_s"]


# ---------------------------------------------------------------------------
# warm compiles across a server restart and across Experiments
# ---------------------------------------------------------------------------

def test_server_warmup_persists_and_restart_is_profile_warm(env, tmp_path):
    from repro_torch.core.data import make_queries
    from repro_torch.serve.server import PipelineServer
    path = tmp_path / "serve_profile.json"
    pipe = T.Retrieve("BM25", k=50) % 10
    srv = PipelineServer(pipe, _backend(env, TuningProfile(path)))
    assert srv.compile_report["tuning"]["probe_measurements"] > 0
    Q = make_queries(np.zeros((1, 3), np.int32), np.ones((1, 3), np.float32),
                     np.array([0]), device="cpu")
    info = srv.warmup(Q)
    assert path.exists()
    assert info["tuning_profile"]["entries"] > 0
    assert srv.stats()["tuning_profile"]["entries"] > 0
    # a restarted server compiles against the persisted profile with zero
    # estimates and zero probes
    srv2 = PipelineServer(pipe, _backend(env, TuningProfile(path)))
    t = srv2.compile_report["tuning"]
    assert t["probe_measurements"] == 0 and t["gate_estimates"] == 0
    assert t["profile_hits"] > 0
    assert srv2.stats()["tuning_profile"]["hits"] > 0
    assert srv2.submit_wait(Q)["docids"].shape == (1, 10)


def test_experiment_twice_on_one_profile_compiles_warm(env, tmp_path):
    path = tmp_path / "exp_profile.json"
    pipes = [T.Retrieve("BM25", k=50) % 10,
             (T.Retrieve("BM25", k=50)
              >> (T.Extract("QL") ** T.Extract("TF_IDF"))) % 10]
    runs = []
    for _ in range(2):
        prof = TuningProfile(path)
        be = _backend(env, prof)
        res = T.Experiment(pipes, env["Q"], env["topics"].qrels, ["map"],
                           backend=be)
        runs.append((prof.info(), be.__dict__.get("_cost_estimates"), res))
    (cold, cold_est, r1), (warm, warm_est, r2) = runs
    assert cold["misses"] == 2 and cold["hits"] == 0 and cold_est
    assert warm["hits"] == 2 and warm["misses"] == 0 and warm_est is None
    assert [row["map"] for row in r1["table"]] == \
        [row["map"] for row in r2["table"]]
    assert r2["plan"].ops[0].kind == r1["plan"].ops[0].kind


def test_pq_block_is_a_param_only_when_tuned(env):
    """A tuned tile rides on the fused stage (and its key) as ``pq_block``
    down to the PQ-scoring kernel's plan; untuned, the stage and its key
    are the untuned ones.  The plain version the CPU runs has no tiles, so
    both give one result."""
    be = _backend(env, autotune=False, default_k=60,
                  caps=frozenset({"fused_dense", "dense_topk", "pq_topk"}))
    plain = T.FusedDenseRetrieve(k=10, nprobe=8, pq=True, pq_shortlist=40)
    tuned = T.FusedDenseRetrieve(k=10, nprobe=8, pq=True, pq_shortlist=40,
                                 pq_block=432)
    assert "pq_block" not in plain.params and tuned.params["pq_block"] == 432
    assert plain.key() != tuned.key()
    a = T.run_pipeline(plain, env["Q"], backend=be)
    b = T.run_pipeline(tuned, env["Q"], backend=be)
    assert torch.equal(a["docids"], b["docids"])
    assert torch.equal(a["scores"], b["scores"])
    op = T.compile_pipeline(T.DenseRetrieve(k=10, nprobe=8, pq=True) % 10, be)
    assert op.params == plain.params


@pytest.mark.parametrize("half_s,kept", [(0.97, True), (0.90, False)])
def test_pq_block_tune_times_the_kernel_alone(env, monkeypatch, half_s,
                                              kept):
    """The PQ tile is probed on the kernel alone: the ADC inputs are built
    once, on a chunk's worth of probe queries, and each tile's kernel call
    is timed; the default tile stays unless another is faster by more than
    PQ_BLOCK_KEEP_WITHIN.  (On the card only in the pass; called here on
    the CPU's plain version, which has no tiles.)"""
    from repro_torch.core.ir import leaf
    from repro_torch.kernels.pq_scoring import ops as PQ
    be = _backend(env, default_k=60, query_chunk=16,
                  caps=frozenset({"fused_dense", "dense_topk", "pq_topk"}))
    idx = be.ivfpq
    tile = PQ.plan(8 * idx.max_list_len, idx.m, idx.codebook.n_codes)[2]
    cands = sorted({PQ.plan(8 * idx.max_list_len, idx.m,
                            idx.codebook.n_codes, b)[2]
                    for b in (tile // 4, tile // 2, tile)})
    assert len(cands) == 3 and cands[-1] == tile
    secs = dict(zip(cands, (1.2, half_s, 1.0)))
    built, blocks, nq = [], [], []
    real_cand, real_pq = TD._pq_candidates, PQ.streaming_pq_topk
    monkeypatch.setattr(TD, "_pq_candidates", lambda ix, q, **kw: (
        built.append(q.shape[0]) or real_cand(ix, q, **kw)))

    def pq_topk(*a, block=None, **kw):
        blocks.append(block)
        return real_pq(*a, block=block, **kw)
    monkeypatch.setattr(PQ, "streaming_pq_topk", pq_topk)

    def timed(fn, args, repeats):
        nq.append(args[1].shape[0])
        out = fn(*args)
        return secs[blocks[-1]], out
    monkeypatch.setattr(TP, "_timed", timed)
    pctx = TP.PassContext(be)
    op = leaf(T.FusedDenseRetrieve(k=10, nprobe=8, pq=True, pq_shortlist=40))
    got = TP.AutotunePass(be.descriptor)._tune_pq_block(
        op, pctx, idx, be.pq_refine)
    assert built == [16] and nq == [16, 16, 16] and blocks == cands
    (d,) = pctx.decisions
    assert d["knob"] == "pq_block" and d["source"] == "measured"
    assert d["overlap_at_k"] == {str(c): 1.0 for c in cands}
    if kept:
        assert got is op and d["chosen"] == tile
    else:
        assert got.params["pq_block"] == cands[1] == d["chosen"]
