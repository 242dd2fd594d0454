"""GAT and the neighbour sampler of the port against the JAX package on the
CPU: the segment softmax where a node has no incoming edge, the sampled
subgraph and the packed molecules of
tests/test_archs_smoke.py::test_gnn_shapes_cells_reduced (forward, loss
and every gradient), and the sampler's arrays from the same seeds.

Weights are the reference's draw carried across by ``from_arrays``;
values agree within atol 1e-5 + rtol 1e-4 of the leaf's largest |value|
(the port's ``index_add`` and ``scatter_reduce`` sum in another order than
XLA's segment ops)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro.models import sampler as jsampler
from repro_torch.models import gnn as tgnn
from repro_torch.models import sampler as tsampler

from test_torch_zoo import assert_leaf_close, flat


def _pair(cfg_kw, seed):
    jcfg = jgnn.GATConfig(name="t", **cfg_kw)
    tcfg = tgnn.GATConfig(name="t", **cfg_kw)
    params = jgnn.init_params(jcfg, jax.random.key(seed))
    return jcfg, params, tcfg, tgnn.from_arrays(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


def _check(jcfg, params, tcfg, gat, batch):
    """Forward, loss, metrics and every gradient against the reference."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        out = tgnn.forward(tcfg, gat, tb)
    want_out = jgnn.forward(jcfg, params, jb)
    assert_leaf_close(out, want_out, "forward")
    (jl, _), jg = jax.value_and_grad(
        lambda p: jgnn.loss_fn(jcfg, p, jb), has_aux=True)(params)
    for p in gat.parameters():
        p.requires_grad_(True)
    loss, met = tgnn.loss_fn(tcfg, gat, tb)
    grads = torch.autograd.grad(loss, list(gat.parameters()))
    assert_leaf_close(loss, jl, "loss")
    assert_leaf_close(met["ce"], jl, "ce")
    want = flat(jg)
    for (n, _), g in zip(gat.named_parameters(), grads):
        assert bool(torch.isfinite(g).all()), n
        assert_leaf_close(g, want[n], f"grad {n}")
    return out


@pytest.mark.parametrize("final", [False, True])
def test_gat_layer_node_without_incoming_edges(final):
    """Nodes 5 and 7 receive no edge: their segment max is -inf, set to 0
    as in the reference, so they aggregate nothing and come out as the bias
    (through ELU in a hidden layer); the others are the reference's."""
    # one layer is a final one (1 head of n_classes); two, a hidden first
    jcfg, params, tcfg, gat = _pair(dict(d_feat=6, n_classes=3, n_heads=2,
                                         d_hidden=4,
                                         n_layers=1 if final else 2), seed=3)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    src = rng.integers(0, 8, 20).astype(np.int32)
    dst = rng.choice([0, 1, 2, 3, 4, 6], 20).astype(np.int32)
    jp, tp = params["layers"][0], gat.layers[0]
    want = jgnn.gat_layer(jp, jnp.asarray(x), jnp.asarray(src),
                          jnp.asarray(dst), 8, final=final)
    with torch.no_grad():
        got = tgnn.gat_layer(tp, torch.from_numpy(x), torch.from_numpy(src),
                             torch.from_numpy(dst), 8, final=final)
    assert bool(torch.isfinite(got).all())
    bias = tp.bias.detach()
    lonely = bias.mean(0) if final else torch.nn.functional.elu(
        bias).reshape(-1)
    for node in (5, 7):
        np.testing.assert_array_equal(got[node].numpy(), lonely.numpy())
    assert_leaf_close(got, want, "gat_layer")


def test_gat_sampled_subgraph_matches_reference():
    """The sampled cell: fanouts (4, 3) from 8 seeds over a 500-node
    random graph, labels masked to the seeds."""
    g = tsampler.random_graph(500, 6, 12, 5)
    sub = tsampler.NeighborSampler(g, [4, 3]).sample(np.arange(8))
    assert sub["x"].shape[0] == 8 + 8 * 4 + 8 * 4 * 3
    jcfg, params, tcfg, gat = _pair(dict(d_feat=12, n_classes=5), seed=0)
    out = _check(jcfg, params, tcfg, gat, sub)
    assert out.shape == (sub["x"].shape[0], 5)


def test_gat_molecule_readout_matches_reference():
    """The molecule cell: 4 packed graphs of 10 nodes and 20 edges, mean
    readout over each graph's nodes."""
    mol = tsampler.pack_molecule_batch(np.random.default_rng(0), 4, 10, 20,
                                       12, 3)
    jcfg, params, tcfg, gat = _pair(dict(d_feat=12, n_classes=3,
                                         readout="mean"), seed=1)
    out = _check(jcfg, params, tcfg, gat, mol)
    assert out.shape == (4, 3)


def test_sampler_arrays_equal_reference():
    """random_graph, NeighborSampler.sample / batches and
    pack_molecule_batch give the reference's arrays from the same seeds."""
    jg, tg = (m.random_graph(300, 5, 7, 4, seed=3)
              for m in (jsampler, tsampler))
    for name in ("indptr", "indices", "features", "labels"):
        a, b = getattr(tg, name), getattr(jg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tg.n_nodes == jg.n_nodes == 300
    js, tsm = (m.NeighborSampler(g, [3, 2], seed=4)
               for m, g in ((jsampler, jg), (tsampler, tg)))
    seeds = np.array([0, 7, 299, 42], np.int64)
    pairs = [(tsm.sample(seeds), js.sample(seeds))]
    pairs += list(zip(tsm.batches(5, 2), js.batches(5, 2)))
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = tsampler.pack_molecule_batch(np.random.default_rng(9), 3, 5, 7,
                                       4, 2)
    want = jsampler.pack_molecule_batch(np.random.default_rng(9), 3, 5, 7,
                                        4, 2)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gat_message_chunks_match_reference(monkeypatch):
    """The aggregation runs MESSAGE_CHUNK edges at a time: chunks of 7
    edges (the last one short) give the forward, loss and gradients of one
    pass, and the reference's."""
    jcfg, params, tcfg, gat = _pair(dict(d_feat=12, n_classes=5), seed=4)
    rng = np.random.default_rng(12)
    batch = {"x": rng.standard_normal((40, 12), dtype=np.float32),
             "src": rng.integers(0, 40, 150, dtype=np.int32),
             "dst": rng.integers(0, 40, 150, dtype=np.int32),
             "labels": rng.integers(0, 5, 40, dtype=np.int32),
             "label_mask": rng.random(40) < 0.5}
    whole = _check(jcfg, params, tcfg, gat, batch)
    monkeypatch.setattr(tgnn, "MESSAGE_CHUNK", 7)
    chunked = _check(jcfg, params, tcfg, gat, batch)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


def test_aggregate_gradcheck(monkeypatch):
    """``_Aggregate``'s hand-written backward against finite differences
    in float64, chunked, with a node that receives no edge."""
    monkeypatch.setattr(tgnn, "MESSAGE_CHUNK", 4)
    rng = np.random.default_rng(13)
    h = torch.tensor(rng.standard_normal((6, 2, 3)), requires_grad=True)
    alpha = torch.tensor(rng.random((11, 2)), requires_grad=True)
    src = torch.from_numpy(rng.integers(0, 6, 11))
    dst = torch.from_numpy(rng.choice([0, 1, 2, 4, 5], 11))
    assert torch.autograd.gradcheck(
        lambda h, a: tgnn._Aggregate.apply(h, a, src, dst, 6), (h, alpha))
