"""One run of one cell: set-up from the seed, the measured window, the
per-layer readings of a traced run, the check against the reference, and
the result line.

A cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); ``workloads/<cell>.json`` holds its pipeline,
its backend's capabilities and the limits of its check; each per-layer
metric is read by ``metrics/<metric>.py``.  A cell's window calls
``Experiment`` on fresh topics, drawn from the seed before the window,
until ``--seconds`` have passed."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

import check
import devtrace
import gen
import pipeline as PL
from reference.evaluate import RefState
from reference.postings import Postings, build_postings

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    spec: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        man = load_json(root / "BENCHMARK.json")
        entry = next((w for w in man["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        conf = next(c for c in man["configs"] if c["name"] == entry["config"])
        e2e = [m for m in man["end_to_end"]
               if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in man["per_layer"]
                     if (name in m["workloads"] if "workloads" in m
                         else m["moves"] in reported)]
        return cls(name, entry, load_json(root / conf["file"]),
                   load_json(root / "bench" / "traffic" /
                             f"{entry['traffic']}.json"),
                   load_json(root / "bench" / "workloads" / f"{name}.json"),
                   e2e, per_layer)


@dataclasses.dataclass
class RunView:
    """What the per-layer readers read: the cell, the window's profile,
    kernel-call shapes, program counters and the work the window did."""
    cell: Cell
    window_s: float
    profile: devtrace.Profile | None
    recorder: devtrace.CallRecorder | None
    counters: dict
    work: dict
    trees: dict


def load_reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Data:
    post: Postings          # the benchmark's own, for topics and the check
    index: object           # the program's


def build_data(cell: Cell, seed: int, device, rt) -> tuple[Data, dict]:
    """The collection drawn from the seed, the benchmark's own postings of
    it, and the program's index built from it by ``build_index``."""
    col = cell.config["collection"]
    parts = {}
    t = time.perf_counter()
    tokens, doc_start = gen.draw_collection(col, seed, device)
    _sync(device)
    parts["collection_s"] = time.perf_counter() - t
    t = time.perf_counter()
    post = build_postings(tokens, doc_start, int(col["vocab"]),
                          float(col["stop_df_fraction"]))
    _sync(device)
    parts["bench_postings_s"] = time.perf_counter() - t
    t = time.perf_counter()
    from repro_torch.index.corpus import Corpus
    corpus = Corpus(tokens.cpu().numpy(), doc_start.cpu().numpy(),
                    int(col["vocab"]))
    del tokens
    index = rt.build_index(corpus, stop_df_fraction=float(
        col["stop_df_fraction"]), device=device)
    del corpus
    _sync(device)
    parts["build_index_s"] = time.perf_counter() - t
    del doc_start
    return Data(post, index), parts


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def descriptor(rt, caps):
    return None if caps is None else rt.BackendDescriptor.default(
        frozenset(caps))


def program_lm(rt, lmcfg: dict, weights: dict, device):
    """The program's LM holding copies of the benchmark's weights."""
    from repro_torch.models import transformer_lm as tlm
    fields = {k: lmcfg[k] for k in (
        "name", "n_layers", "d_model", "n_q", "n_kv", "d_head", "d_ff",
        "vocab", "qkv_bias", "tie_embeddings", "rope_theta", "norm_eps",
        "attn_impl")}
    cfg = tlm.LMConfig(**fields, dtype=getattr(torch, lmcfg["dtype"]))
    lm = tlm.TransformerLM(cfg, device=device)
    with torch.no_grad():
        lm.embed.copy_(weights["embed"])
        lm.ln_final.copy_(weights["ln_final"])
        for blk, w in zip(lm.layers, weights["layers"]):
            for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
                if name in w:
                    getattr(blk.attn, name).copy_(w[name])
            for name in ("w_gate", "w_up", "w_down"):
                getattr(blk.mlp, name).copy_(w[name])
            blk.ln_attn.copy_(w["ln_attn"])
            blk.ln_mlp.copy_(w["ln_mlp"])
    return cfg, lm


def lowering(rt, pipe, be, optimize: bool = True) -> list[str]:
    from repro_torch.core import ir
    return [op.kind for op in ir.chain(
        rt.compile_pipeline(pipe, be, optimize=optimize))]


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

#: calls drawn together (one pass on the device for their judgements)
DRAW_BLOCK = 16


def calls_to_draw(seconds: float, s_per_topic: float, n: int) -> int:
    """Calls to draw before the window: twice as many as the steady time a
    topic says the window holds, plus two, in whole blocks."""
    want = 2.0 * seconds / max(s_per_topic * n, 1e-6) + 2
    return DRAW_BLOCK * math.ceil(want / DRAW_BLOCK)


def with_check_rows(cell, calls, check_rng, device) -> list[dict]:
    """Each call's ``check.per_call`` rows for the check, drawn from the
    seed in call order, with their index on the device."""
    per_call = int(cell.spec["check"]["per_call"])
    for topics in calls:
        rows = check_rng.choice(len(topics["qid"]), per_call, replace=False)
        topics["check_rows"] = rows
        topics["check_idx"] = torch.as_tensor(rows, device=device)
    return calls


def experiment_window(cell, rt, be, pipe, draw, pre, seconds, device,
                      profile, recorder):
    """Experiment calls, each on the next set of topics drawn before the
    window, until ``seconds`` have passed (the call in flight finishes);
    each call keeps its check rows of the result tensors.  Should the
    drawn calls run out, ``draw()`` draws more inside the window (and that
    is logged).  Returns (window seconds, the topics of each call, the kept
    rows of each call, the last call's measures)."""
    tr = cell.traffic
    keys = ("docids", "scores", "features", "tokens")
    used, outs, late_draws = [], [], 0
    ctx = profile.window() if profile is not None else contextlib.nullcontext()
    rec = recorder.window() if recorder is not None else contextlib.nullcontext()
    with ctx, rec:
        t0 = time.perf_counter()
        while True:
            if len(used) == len(pre):
                more = draw()
                pre += more
                late_draws += len(more)
            topics = pre[len(used)]
            Q = rt.make_queries(topics["terms"], topics["weights"],
                                topics["qid"], device=device)
            res = rt.Experiment([pipe], Q, topics["qrels"], tr["measures"],
                                backend=be)
            R = res["results"][0]
            outs.append({k: R[k].index_select(0, topics["check_idx"])
                         for k in keys if k in R})
            used.append(topics)
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        window = time.perf_counter() - t0
    if late_draws:
        log(f"[bench] {late_draws} calls' topics drawn inside the window "
            f"({len(pre) - late_draws} drawn before it)")
    return window, used, outs, res["table"][0]


def sampled_rows(used, outs) -> list:
    """(terms, weights, outputs) of the check's rows of each call, on the
    host."""
    return [(u["terms"][u["check_rows"]], u["weights"][u["check_rows"]],
             {k: v.cpu() for k, v in out.items()})
            for u, out in zip(used, outs)]


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def kernel_build(device) -> float:
    """Seconds spent building the program's CUDA kernel library: ``nvcc``
    runs only in the first run of a checkout, later runs find the library
    built (a hash of the sources, milliseconds).  Loading the library
    stays in set-up, at its first use."""
    if torch.device(device).type != "cuda":
        return 0.0
    from repro_torch.kernels import _build
    t = time.perf_counter()
    _build.build()
    return time.perf_counter() - t


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> dict:
    """One run; returns the result dict (without printing it).  Raises on
    any failure.  ``setup_s`` runs from ``t_start`` to the first timed
    call, less the kernel library's build (recorded apart as
    ``kernel_build_s``).  With ``control`` the result also holds the
    numbers of the control (the reference in the precision below, in the
    program's place on the same sampled queries) under
    ``control_checks``."""
    import repro_torch as rt
    parts: dict = {"imports_s": time.perf_counter() - t_start}
    build_s = kernel_build(device)
    recorder = devtrace.CallRecorder().install() if trace else None
    data, p = build_data(cell, seed, device, rt)
    parts.update(p)
    be = rt.TorchBackend(data.index,
                         default_k=int(cell.config["index"]["default_k"]),
                         bucket_ladder=tuple(cell.traffic["ladder"]),
                         descriptor=descriptor(rt, cell.spec.get("caps")),
                         device=device)
    weights = None
    lmcfg = cell.config.get("lm")
    if lmcfg is not None:
        t = time.perf_counter()
        weights = gen.lm_weights(lmcfg, seed, device)
        cfg, lm = program_lm(rt, lmcfg, weights, device)
        be.register_lm(lmcfg["name"], cfg, lm)
        _sync(device)
        parts["lm_weights_s"] = time.perf_counter() - t
        del lm
    if "dense" in cell.config:
        t = time.perf_counter()
        be.dense                           # the program's dense build
        _sync(device)
        parts["dense_build_s"] = time.perf_counter() - t
    stream = gen.TopicStream(data.post, cell.traffic, seed, "topics")
    warm = gen.TopicStream(data.post, cell.traffic, seed, "warmup")
    engine = be.engine
    tree = PL.parse(cell.spec["pipeline"])
    trees = {"": tree}
    pipe = PL.build(tree, rt)
    got = lowering(rt, pipe, be)
    if got != cell.spec["lowers_to"]:
        raise RuntimeError(f"pipeline lowers to {got}, the cell expects "
                           f"{cell.spec['lowers_to']}")
    # warm-up: two calls on the window's shapes, the second timed for the
    # steady time a topic, from which the window's calls are drawn ahead
    n = int(cell.traffic["topics_per_call"])
    nw = int(cell.spec.get("warmup_topics", n))
    t = time.perf_counter()
    for _ in range(2):
        w = warm.draw(nw)
        t_call = time.perf_counter()
        rt.Experiment([pipe], rt.make_queries(w["terms"], w["weights"],
                                              w["qid"], device=device),
                      w["qrels"], cell.traffic["measures"], backend=be)
        _sync(device)
    s_per_topic = (time.perf_counter() - t_call) / nw
    parts["warmup_s"] = time.perf_counter() - t
    t = time.perf_counter()
    check_rng = gen.rng(seed, "check")

    def draw():
        return with_check_rows(cell, stream.draw_calls(DRAW_BLOCK, n),
                               check_rng, device)
    pre = []
    for _ in range(calls_to_draw(seconds, s_per_topic, n) // DRAW_BLOCK):
        pre += draw()
    _sync(device)
    parts["topics_s"] = time.perf_counter() - t
    log(f"[bench] topics drawn for {len(pre)} calls")
    setup_s = time.perf_counter() - t_start - build_s
    profile = devtrace.Profile() if trace else None
    before = _counters(engine)
    window, used, outs, row = experiment_window(
        cell, rt, be, pipe, draw, pre, seconds, device, profile, recorder)
    after = _counters(engine)
    del pre
    nq = sum(len(u["qid"]) for u in used)
    calls = [u["terms"] for u in used]
    work = {"queries": nq, "calls": len(calls), "topics": calls,
            "measures": row}
    e2e = {"queries_per_s": nq / window}
    attempted, failed = nq, 0
    checks_in = sampled_rows(used, outs)
    del outs, used
    if trace:
        work["df"] = data.post.df.cpu().numpy()
    counters = {k: after[k] - before[k] for k in after}
    log(f"[bench] window {window:.3f} s, {attempted} attempted, {failed} "
        f"failed; engine {counters}")
    metrics = {m["name"]: m for m in cell.end_to_end}
    result_metrics = {}
    if not trace:
        values = {**e2e, "setup_s": setup_s}
        for name, m in metrics.items():
            if name not in values:
                raise RuntimeError(f"the harness computes no {name}")
            result_metrics[name] = {"value": values[name], "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if torch.device(device).type == "cuda"
                                 else 0)}
    breakdown = None
    if trace:
        view = RunView(cell, window, profile, recorder, counters, work, trees)
        for m in cell.per_layer:
            v = load_reader(m["name"])(view)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if profile is not None and profile.device:
            dev["busy_s"] = profile.busy_s()
            dev["window_s"] = profile.window_s
            breakdown = {"device_ops": profile.device_ops(),
                         "idle_gaps": profile.idle_gaps()}
            log(f"[bench] trace: {len(profile.device)} device operations, "
                f"read in {profile.collect_s:.1f} s")
        recorder.uninstall()
    log(f"[bench] kernel library build {build_s:.3f} s (apart from set-up); "
        f"set-up parts (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()) +
        f"; setup_s {setup_s:.3f}")
    # the check: program state freed, then the reference
    del be, engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = reference_check(cell, trees, data, weights, checks_in, seed,
                              device)
    limits = cell.spec["limits"]
    ok = check.verdict(numbers, limits)
    if control:
        ctl = reference_check(cell, trees, data, weights, checks_in, seed,
                              device, control=True)
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["control_checks"] = {k: {"value": v, "limit": limits.get(k)}
                                 for k, v in ctl.items()}
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in numbers.items()}
    return out


def _counters(engine) -> dict:
    if engine is None:
        return {"engine_dispatches": 0, "engine_compiles": 0}
    return {"engine_dispatches": engine.n_dispatches,
            "engine_compiles": engine.n_compiles_total}


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def reference_state(cell, data: Data, device, dtype=torch.float32) -> RefState:
    st = RefState(post=data.post,
                  default_k=int(cell.config["index"]["default_k"]),
                  dtype=dtype)
    if "dense" in cell.config or "lm" in cell.config:
        st.doc_terms = data.post.doc_major()
    if "dense" in cell.config:
        from reference.dense import projection
        d = cell.config["dense"]
        st.proj = projection(data.post.vocab, int(d["dim"]),
                             int(d["projection_seed"]), data.post.doc.device)
    return st


def reference_check(cell, trees, data, weights, checks_in, seed, device,
                    control: bool = False) -> dict:
    """The numbers of the check over the sampled queries (up to the cell's
    ``check.max``, drawn from the seed): the program's outputs, or with
    ``control`` the reference in the precision below in their place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    rows = [(r[0][j:j + 1], r[1][j:j + 1],
             {k: v[j:j + 1] for k, v in r[2].items()})
            for r in checks_in for j in range(r[0].shape[0])]
    cap = int(cell.spec["check"]["max"])
    if len(rows) > cap:
        pick = gen.rng(seed, "check.sample").choice(len(rows), cap,
                                                   replace=False)
        rows = [rows[i] for i in sorted(pick.tolist())]
    st = reference_state(cell, data, device)
    low = dataclasses.replace(st, dtype=torch.bfloat16) if control else None
    per_query, lm_rows = [], []
    tree = trees[""]
    for terms, wts, out in rows:
        for j in range(terms.shape[0]):
            o = {k: v[j].to(st.post.doc.device) for k, v in out.items()}
            tm, wt = terms[j].tolist(), wts[j].tolist()
            if control:
                from reference.evaluate import evaluate
                c = evaluate(tree, low, tm, wt)
                K = o["docids"].shape[0]
                o = {"docids": c["docids"][:K], "scores": c["scores"][:K]}
                if c["features"] is not None:
                    o["features"] = c["features"][:K]
            per_query.append(check.compare_query(tree, st, tm, wt, o))
            if "tokens" in out:
                lm_rows.append({"terms": tm, "docids": out["docids"][j].tolist(),
                                "tokens": out["tokens"][j]})
    numbers = check.worst(per_query)
    if lm_rows:
        lmcfg = cell.config["lm"]
        prompts = check.prompts_for(tree, st, lmcfg, lm_rows)
        tokens = torch.stack([r["tokens"] for r in lm_rows]).to(prompts.device)
        gaps, margin = check.logit_gaps(lmcfg, weights, prompts, tokens,
                                        lowp=control)
        numbers["logit_gap"] = float(gaps.max())
        q = torch.quantile(margin.flatten().float(),
                           torch.tensor([0.0, 0.01, 0.5], device=margin.device))
        log(f"[bench] LM check{' (control)' if control else ''}: "
            f"{tokens.shape[0]} answers, {int(torch.unique(tokens).numel())} "
            f"distinct tokens, {int((gaps > 0).sum())} of {gaps.numel()} "
            f"positions off the reference's best; the reference's margin of "
            f"best over second: min {float(q[0]):.4f}, 1% {float(q[1]):.4f}, "
            f"median {float(q[2]):.4f}")
    log(f"[bench] check of {len(per_query)} queries in "
        f"{time.perf_counter() - t:.1f} s")
    return numbers


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
