"""The port's RAG pipeline (``Generate`` in ``core/stages.py``, its
A-schema rules in ``core/passes.py``, ``TorchBackend.register_lm``) against
the JAX package on the CPU.

Both backends hold the same index, the same dense embeddings and the same
tiny float32 LM (the JAX ``init_params`` draw carried across with
``lm_from_arrays``); the pipeline runs through ``run_pipeline`` on each,
the JAX "pallas" path in interpret mode.  Prompts are equal exactly,
rankings at the reference tolerances, tokens equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.configs import llama4_scout_17b_a16e as jllama4
from repro.configs import olmoe_1b_7b as jolmoe
from repro.core import DenseRerank as JDenseRerank
from repro.core import Generate as JGenerate
from repro.core import Retrieve as JRetrieve
from repro.core.compiler import JaxBackend
from repro.core.compiler import run_pipeline as jrun
from repro.core.stages import assemble_prompt_fn as jassemble
from repro.index.inverted import build_index as jbuild
from repro_torch.core import SchemaError, compile_pipeline, ir, lower
from repro_torch.core.passes import annotate
from repro_torch.core.stages import assemble_prompt_fn
from repro_torch.core.transformer import Transformer
from repro_torch.index import dense as TD
from repro_torch.index.inverted import build_index as tbuild
from repro_torch.models import transformer_lm as TT

from test_torch_generate import _carry, _port_cfg, _tiny_jcfg
from torch_parity import (assert_ranking_parity, jax_queries, small_env,
                          torch_queries)

# ---------------------------------------------------------------------------
# the RAG pipeline against the reference backend
# ---------------------------------------------------------------------------

MOE_LMS = {"olmoe-smoke": jolmoe.reduced, "llama4-smoke": jllama4.reduced}


@pytest.fixture(scope="module")
def env():
    corpus, topics, _ = small_env()
    jidx = jbuild(corpus)
    jbe = JaxBackend(jidx, default_k=60, query_chunk=4, sharded=False)
    tbe = rt.TorchBackend(tbuild(corpus, device="cpu"),
                          TD.dense_from_arrays(np.asarray(jbe.dense.emb),
                                               "cpu"),
                          default_k=60, query_chunk=4, device="cpu")
    for impl in ("xla", "pallas"):
        jcfg = _tiny_jcfg("float32", impl)
        params, lm = _carry(jcfg, seed=2)
        jbe.register_lm(f"tiny-{impl}", jcfg, params)
        tbe.register_lm(f"tiny-{impl}", _port_cfg(jcfg), lm)
    # the MoE LMs in float32: the reference on its "xla" path (its
    # "pallas" path drops llama4's chunk), the port on both; tbe8 decodes
    # all 8 topics in one chunk, as the reference's Generate does
    tbe8 = rt.TorchBackend(tbe.index, tbe.dense, default_k=60,
                           query_chunk=8, device="cpu")
    for name, reduced in MOE_LMS.items():
        jcfg = dataclasses.replace(reduced()[0], dtype=jnp.float32,
                                   remat=False)
        params, lm = _carry(jcfg, seed=3)
        jbe.register_lm(name, jcfg, params)
        for impl in ("xla", "pallas"):
            for be in (tbe, tbe8):
                be.register_lm(f"{name}-{impl}", dataclasses.replace(
                    _port_cfg(jcfg), attn_impl=impl), lm)
    return {"jbe": jbe, "tbe": tbe, "tbe8": tbe8, "jQ": jax_queries(topics),
            "tQ": torch_queries(topics)}


def _rag(pkg, model="tiny-xla", k=8, T=6, P=32, docs=3):
    R, D, G = ((JRetrieve, JDenseRerank, JGenerate) if pkg == "jax"
               else (rt.Retrieve, rt.DenseRerank, rt.Generate))
    return (R("BM25") >> D() % k
            >> G(model, max_new_tokens=T, max_prompt_len=P, prompt_docs=docs))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rag_pipeline_matches_reference(env, impl):
    model = f"tiny-{impl}"
    want = jrun(_rag("jax", model), env["jQ"], backend=env["jbe"])
    got = rt.run_pipeline(_rag("torch", model), env["tQ"],
                          backend=env["tbe"])
    assert_ranking_parity(np.asarray(want["docids"]),
                          np.asarray(want["scores"]), got["docids"].numpy(),
                          got["scores"].numpy(), what=f"RAG {impl}")
    np.testing.assert_array_equal(got["docids"][:, :3].numpy(),
                                  np.asarray(want["docids"])[:, :3])
    assert got["tokens"].shape == (8, 6)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(MOE_LMS))
def test_rag_pipeline_on_moe_lms_matches_reference(env, name, impl):
    """The RAG leaf on olmoe-smoke and llama4-smoke: prompts of 48 tokens
    cross llama4's chunk of 16 twice.  The reference's Generate routes all
    8 prompts in one MoE call; the port's decodes each chunk of its plan
    as one batch, here one chunk of 8: tokens equal."""
    want = jrun(_rag("jax", name, P=48), env["jQ"], backend=env["jbe"])
    got = rt.run_pipeline(_rag("torch", f"{name}-{impl}", P=48), env["tQ"],
                          backend=env["tbe8"])
    np.testing.assert_array_equal(got["docids"][:, :3].numpy(),
                                  np.asarray(want["docids"])[:, :3])
    assert got["tokens"].shape == (8, 6)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


@pytest.mark.parametrize("name", list(MOE_LMS))
def test_moe_generate_routes_each_chunk_as_one_batch(env, name):
    """The recorded deviation (ROADMAP §3): with chunks of 4 the port's
    tokens equal the reference's run chunk by chunk, since an MoE call's
    capacity counts the tokens of its own batch."""
    got = rt.run_pipeline(_rag("torch", f"{name}-pallas", P=48), env["tQ"],
                          backend=env["tbe"])
    want = np.concatenate([np.asarray(jrun(
        _rag("jax", name, P=48), {k: v[i:i + 4] for k, v in env["jQ"].items()},
        backend=env["jbe"])["tokens"]) for i in (0, 4)])
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


@pytest.mark.parametrize("name", list(MOE_LMS))
def test_moe_generate_pads_the_last_chunk_without_rerouting(env, name):
    """6 topics in chunks of 4: the last chunk's 2 prompts are padded with
    2 zero rows to the bucket of 4, and the MoE layers' capacity counts
    the 2 real prompts alone, so the tokens equal the reference's run
    chunk by chunk (4, then 2): the bucket ladder changes no answer."""
    Q6 = {k: v[:6] for k, v in env["tQ"].items()}
    got = rt.run_pipeline(_rag("torch", f"{name}-pallas", P=48, T=8), Q6,
                          backend=env["tbe"])
    want = np.concatenate([np.asarray(jrun(
        _rag("jax", name, P=48, T=8), {k: v[i:j] for k, v in
                                       env["jQ"].items()},
        backend=env["jbe"])["tokens"]) for i, j in ((0, 4), (4, 6))])
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


@pytest.mark.parametrize("P,docs", [(32, 3), (100, 1), (4096, 4)])
def test_prompts_equal_reference(env, P, docs):
    """Integer-exact prompt assembly, short prompts cut and long ones
    repeated cyclically; docids include -1 padding."""
    jidx, tidx = env["jbe"].index, env["tbe"].index
    docids = np.array([[5, 17, 2999, -1], [-1, -1, -1, -1], [0, 1, 2, 3]],
                      np.int32)
    terms = np.asarray(env["jQ"]["terms"])[:3]
    want = jax.jit(jax.vmap(jassemble(jidx, vocab=128, max_prompt_len=P,
                                      prompt_docs=docs)))(
        jnp.asarray(terms), jnp.zeros(terms.shape), jnp.asarray(docids))
    got = assemble_prompt_fn(tidx, vocab=128, max_prompt_len=P,
                             prompt_docs=docs)(
        torch.tensor(terms), torch.zeros(terms.shape), torch.tensor(docids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_stage_prompts_equal_reference(env):
    """The stage's own assembler over the ranking the pipeline feeds it."""
    from repro.core.compiler import Context as JContext
    from repro_torch.core.compiler import Context
    R = rt.run_pipeline(rt.Retrieve("BM25") >> rt.DenseRerank() % 8,
                        env["tQ"], backend=env["tbe"])
    g = rt.Generate("tiny-xla", max_prompt_len=48, prompt_docs=4)
    jg = JGenerate("tiny-xla", max_prompt_len=48, prompt_docs=4)
    got = g.assemble(Context(env["tbe"]), env["tQ"], R)
    want = jg.assemble(JContext(env["jbe"]), env["jQ"],
                       {"docids": jnp.asarray(R["docids"].numpy())})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# A-schema typing (tests/test_generate.py on the port)
# ---------------------------------------------------------------------------

class _QRewrite(Transformer):
    """A pure Q -> Q stage (the port has no query rewrite yet)."""
    kind = "q_rewrite"
    out_kind = "Q"
    reads_results = False


def test_generate_over_pure_query_expression_is_schema_error(env):
    with pytest.raises(SchemaError, match="pure Q -> Q"):
        compile_pipeline(_QRewrite() >> rt.Generate("tiny-xla"), env["tbe"])


def test_generate_is_terminal_no_stage_may_consume_a(env):
    be = env["tbe"]
    base = rt.Retrieve("BM25", k=20) >> rt.Generate("tiny-xla")
    with pytest.raises(SchemaError, match="terminal"):
        compile_pipeline(base % 5, be)                  # cutoff over A
    with pytest.raises(SchemaError, match="terminal"):
        compile_pipeline(2.0 * base, be)                # scale over A
    with pytest.raises(SchemaError, match="terminal"):
        compile_pipeline(base >> rt.DenseRerank(), be)  # rerank over A
    with pytest.raises(SchemaError, match="terminal"):
        compile_pipeline(base + rt.Retrieve("QL", k=20), be)
    with pytest.raises(SchemaError, match="terminal"):
        compile_pipeline(base ** rt.Retrieve("QL", k=20), be)
    with pytest.raises(SchemaError):
        compile_pipeline(base | rt.Retrieve("QL", k=20), be)


def test_generate_schema_carries_static_decode_width(env):
    op = lower(_rag("torch", k=8, T=6))
    s = annotate(op, env["tbe"])[id(op)]
    assert s.out == "A"
    assert s.k == 8          # result depth the prompt reads
    assert s.width == 6      # static decode length
    assert s.reads_results


def test_generate_ir_round_trip_preserves_key():
    pipe = _rag("torch")
    assert rt.raise_ir(lower(pipe)).key() == pipe.key()


def test_opt_on_equals_opt_off_with_generate(env):
    Q = {k: v[:4] for k, v in env["tQ"].items()}
    off = rt.run_pipeline(_rag("torch"), Q, backend=env["tbe"],
                          optimize=False)
    on = rt.run_pipeline(_rag("torch"), Q, backend=env["tbe"], optimize=True)
    np.testing.assert_array_equal(off["tokens"].numpy(), on["tokens"].numpy())
    np.testing.assert_array_equal(off["docids"].numpy(),
                                  on["docids"].numpy())


def test_fusion_still_fires_beneath_generate(env):
    op = compile_pipeline(_rag("torch"), env["tbe"])
    kinds = [o.kind for o in ir.chain(op)]
    assert kinds[-1] == "generate"
    assert "fused_dense_rerank" in kinds     # rewrite ran under the A leaf


def test_register_lm_draws_on_the_backend_device_and_names_the_gap(env):
    be = env["tbe"]
    cfg = _port_cfg(_tiny_jcfg())
    be.register_lm("drawn", cfg, seed=5)
    c, lm = be.lm("drawn")
    assert c is cfg and lm.embed.device.type == "cpu"
    again = TT.init_params(cfg, torch.Generator().manual_seed(5))
    assert torch.equal(lm.embed, again.embed)
    with pytest.raises(KeyError, match="register_lm"):
        be.lm("missing")
