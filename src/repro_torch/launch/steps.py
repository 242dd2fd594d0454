"""Step bundles: (arch x shape x mesh) -> a step function and its inputs
(the port of ``src/repro/launch/steps.py``).  This is the one bridge that
the dry run, the chip smoke run and the launchers share.

:func:`build_bundle` returns the step and its arguments: tensors on the
device asked for.  On ``"meta"`` they hold no storage, the counterpart of
the reference's ``ShapeDtypeStruct``s, so a dry run of a full-width cell
allocates nothing (``launch/dryrun.py`` prices it by the op counter); on
any other device the weights are drawn from a generator seeded 0 and the
inputs are valid draws (ids below their vocabularies).
``donate_argnums`` says which arguments the step updates in place (the
train state, the KV cache).

With ``mesh`` (``launch/mesh.py``: a live mesh of cards, or a shape-only
one with ``device="meta"``) the LM steps take the rank's shards of their
arguments, laid out as the reference's ``in_shardings`` say, and return
their results as its ``out_shardings`` say; the bundle carries both as
the port's specs (``repro_torch/sharding.py``).  The serve steps return
the logits and the cache; the train step updates the rank's state (its
parameters' shards and its ZeRO-1 moments) in place and returns the
global metrics.  The draws are the one-card draws, each cut to the rank's
shard.  The zoo's bundles on a mesh of more than one card wait for the
zoo's slice (:class:`WaitsForSlice`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch import sharding as sh
from repro_torch.common import resolve_device, round_up
from repro_torch.configs.registry import ArchDef, get_arch
from repro_torch.models import transformer_lm as tlm
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts

#: an input's (shape, dtype)
Spec = tuple[tuple[int, ...], torch.dtype]

#: the GNN cells' pad multiple: the reference's 128 x the mesh's size, one
#: device here
GNN_PAD_MULTIPLE = 128


class WaitsForSlice(NotImplementedError):
    """A bundle that a later slice of the port puts on a mesh."""


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    args: tuple
    donate_argnums: tuple[int, ...] = ()
    model_flops_per_step: float = 0.0   # 6·N·D-style useful-FLOPs estimate
    #: on a mesh: the specs of the arguments and of the result, as the
    #: reference's shardings (None on one card)
    in_shardings: tuple | None = None
    out_shardings: tuple | None = None


class _Draw:
    """Fills a bundle's inputs on its device: nothing on ``meta``, else
    from one generator seeded 0 (the weights first, then the inputs).
    With ``mesh``, each draw is made whole and cut to the rank's shard."""

    def __init__(self, device: torch.device, mesh=None):
        self.device = device
        self.mesh = mesh
        self.gen = None if device.type == "meta" else \
            torch.Generator(device).manual_seed(0)

    def params(self, module, cfg):
        """``module`` (the family's model module)'s parameters of
        ``cfg``: uninitialised on ``meta``, else ``init_params``' draw."""
        if self.gen is None:
            if module is tlm:
                return tlm.TransformerLM(cfg, self.device, mesh=self.mesh)
            name = _CLASS[module.__name__.rsplit(".", 1)[-1]]
            return getattr(module, name)(cfg, self.device)
        if module is tlm:
            return tlm.init_params(cfg, self.gen, mesh=self.mesh)
        return module.init_params(cfg, self.gen, self.device)

    def shard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The rank's shard of ``t`` by ``spec`` (all of it without a
        mesh)."""
        if self.mesh is None:
            return t
        return t[sh.local_slices(spec, t.shape, self.mesh,
                                 self.mesh.coords)].clone()

    def empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=self.device)

    def ints(self, shape, high, dtype=torch.int32) -> torch.Tensor:
        """Uniform below ``high`` (an int, or a tensor broadcast over the
        last axis: one bound a field)."""
        if self.gen is None:
            return self.empty(shape, dtype)
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float64)
        high = torch.as_tensor(high, dtype=torch.float64, device=self.device)
        return (u * high).floor_().to(dtype)

    def normal(self, shape) -> torch.Tensor:
        if self.gen is None:
            return self.empty(shape, torch.float32)
        return torch.randn(shape, generator=self.gen, device=self.device)

    def below(self, shape, p: float, dtype) -> torch.Tensor:
        """Bernoulli(p) as ``dtype``."""
        if self.gen is None:
            return self.empty(shape, dtype)
        return (torch.rand(shape, generator=self.gen, device=self.device)
                < p).to(dtype)


#: the parameter class of each zoo model module
_CLASS = {"gnn": "GAT", "dcn": "DCN", "autoint": "AutoInt", "dien": "DIEN",
          "mind": "MIND"}


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _lm_model_flops(cfg, tokens: int, kind: str) -> float:
    n = cfg.params_active
    return (6.0 if kind == "train" else 2.0) * n * tokens


def _lm_train(arch: ArchDef, cell, draw: _Draw, opt_cfg) -> StepBundle:
    """A train step that updates its state in place.  On a mesh the state
    is the rank's shards (the parameters by ``param_specs``, the moments
    ZeRO-1, the step replicated) and the batch, drawn whole, the rank's
    rows of it (``transformer_lm.shard_batch``: its share of each
    micro-batch in turn; with one micro-batch its ``(BATCH, None)``
    block)."""
    cfg = arch.model_cfg("train_4k")
    mesh = draw.mesh
    n_micro = arch.train_microbatches
    state = ts.init_state(draw.params(tlm, cfg))
    B, S = cell["batch"], cell["seq"]
    batch = {"tokens": draw.ints((B, S), cfg.vocab),
             "targets": draw.ints((B, S), cfg.vocab)}
    in_sh = out_sh = None
    if mesh is not None:
        batch = tlm.shard_batch(cfg, mesh, batch, n_micro)
        tok = tlm.train_specs(cfg, mesh, B, S)["tokens"]
        st = tlm.state_specs(cfg, mesh)
        in_sh = (st, {"tokens": tok, "targets": tok})
        out_sh = (st, sh.P())
    fn = ts.make_train_step(functools.partial(tlm.loss_fn, cfg, mesh=mesh),
                            opt_cfg, n_micro=n_micro)
    return StepBundle(
        name="train_step", fn=fn, args=(state, batch), donate_argnums=(0,),
        model_flops_per_step=_lm_model_flops(cfg, B * S, "train"),
        in_shardings=in_sh, out_shardings=out_sh)


def _lm_serve(arch: ArchDef, shape_name: str, cell,
              draw: _Draw) -> StepBundle:
    """A prefill or decode step against a KV cache that it updates in
    place (the reference donates it: a functional copy of decode_32k's
    cache would not fit the card).  The decode position is a 0-d int32
    tensor on the host, the last slot of the cache: the port's
    ``decode_step`` slices the cache at it.  On a mesh the tokens, the
    cache (its whole shape under "shape") and the parameters are the
    rank's shards."""
    cfg = arch.model_cfg(shape_name)
    mesh = draw.mesh
    params = draw.params(tlm, cfg)
    if cell["kind"] == "prefill":
        B, S = cell["batch"], cell["seq"]
        T, new_tokens = S, B * S
    else:
        B, T = cell["batch"], cell["kv_len"]
        S, new_tokens = 1, B
    tokens = draw.ints((B, S), cfg.vocab)
    if mesh is None:
        shape = (cfg.n_layers, B, T, cfg.n_kv, cfg.d_head)
        cache = {n: torch.zeros(shape, dtype=cfg.dtype, device=draw.device)
                 for n in ("k", "v")}
        in_sh = out_sh = None
    else:
        specs = tlm.serve_specs(cfg, mesh, B, S, T)
        tokens = draw.shard(tokens, specs["tokens"])
        cache = tlm.init_kv_cache(cfg, B, T, device=draw.device, mesh=mesh)
        cache_sh = {"k": specs["cache"], "v": specs["cache"]}
        in_sh = (tlm.param_specs(cfg, mesh), specs["tokens"], cache_sh)
        if cell["kind"] != "prefill":
            in_sh += (sh.P(),)
        out_sh = (specs["logits"], cache_sh)

    if cell["kind"] == "prefill":
        @torch.no_grad()
        def serve_step(params, tokens, cache):
            return tlm.prefill(cfg, params, tokens, cache, mesh=mesh)
        args = (params, tokens, cache)
    else:
        @torch.no_grad()
        def serve_step(params, tokens, cache, pos):
            return tlm.decode_step(cfg, params, tokens, cache, int(pos),
                                   mesh=mesh)
        args = (params, tokens, cache,
                torch.tensor(T - 1, dtype=torch.int32))
    return StepBundle(
        name="serve_step", fn=serve_step, args=args, donate_argnums=(2,),
        model_flops_per_step=_lm_model_flops(cfg, new_tokens, "serve"),
        in_shardings=in_sh, out_shardings=out_sh)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _pad_graph(batch: dict[str, torch.Tensor],
               multiple: int) -> dict[str, torch.Tensor]:
    """Pad nodes/edges to multiples of ``multiple``; padded edges
    self-loop on a dummy node, padded labels are masked out."""
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    N, E = x.shape[0], src.shape[0]
    Np = round_up(N + 1, multiple)
    Ep = round_up(E, multiple)
    F = torch.nn.functional
    out = dict(batch)
    out["x"] = F.pad(x, (0, 0, 0, Np - N))
    dummy = Np - 1
    out["src"] = F.pad(src, (0, Ep - E), value=dummy)
    out["dst"] = F.pad(dst, (0, Ep - E), value=dummy)
    if "graph_ids" in batch:   # graph-level labels: pad a dummy graph
        G = batch["node_counts"].shape[0]
        out["graph_ids"] = F.pad(batch["graph_ids"], (0, Np - N), value=G)
        out["node_counts"] = F.pad(batch["node_counts"], (0, 1), value=1)
        out["labels"] = F.pad(batch["labels"], (0, 1))
        mask = batch.get("label_mask")
        if mask is None:
            mask = torch.ones((G,), dtype=torch.bool, device=x.device)
        out["label_mask"] = F.pad(mask, (0, 1))
    else:
        mask = batch.get("label_mask")
        if mask is None:
            mask = torch.ones((N,), dtype=torch.bool, device=x.device)
        out["labels"] = F.pad(batch["labels"], (0, Np - N))
        out["label_mask"] = F.pad(mask, (0, Np - N))
    return out


def _gnn_flops(cfg, n_nodes: int, n_edges: int) -> float:
    # dense projections + edge messages, fwd+bwd (×3 of fwd)
    f = 0.0
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = 1 if last else cfg.n_heads
        fdim = cfg.n_classes if last else cfg.d_hidden
        f += 2.0 * n_nodes * d_in * h * fdim      # X @ W
        f += 4.0 * n_edges * h * fdim             # messages + weighting
        d_in = h * fdim
    return 3.0 * f


def _gnn_train(arch: ArchDef, shape_name: str, cell, draw: _Draw,
               opt_cfg) -> StepBundle:
    """A train step on a graph of the cell's published size; the step
    pads it to ``GNN_PAD_MULTIPLE`` inside, as the reference's does."""
    cfg = arch.model_cfg(shape_name)
    mod = arch.module
    state = ts.init_state(draw.params(mod, cfg))
    i32 = torch.int32
    if "n_graphs" in cell:
        G, n, e = cell["n_graphs"], cell["nodes_per_graph"], \
            cell["edges_per_graph"]
        N, E = G * n, G * e
        graphs = torch.arange(G, dtype=i32, device=draw.device)
        # each graph's edges join its own nodes, as the molecule packer's
        base = graphs.repeat_interleave(e) * n
        batch = {
            "x": draw.normal((N, cell["d_feat"])),
            "src": draw.ints((E,), n) + base,
            "dst": draw.ints((E,), n) + base,
            "graph_ids": graphs.repeat_interleave(n),
            "node_counts": torch.full((G,), n, dtype=i32,
                                      device=draw.device),
            "labels": draw.ints((G,), cell["n_classes"]),
        }
    else:
        N, E = cell["n_nodes"], cell["n_edges"]
        batch = {
            "x": draw.normal((N, cell["d_feat"])),
            "src": draw.ints((E,), N), "dst": draw.ints((E,), N),
            "labels": draw.ints((N,), cell["n_classes"]),
            "label_mask": torch.ones((N,), dtype=torch.bool,
                                     device=draw.device),
        }

    def loss(params, batch):
        return mod.loss_fn(cfg, params, _pad_graph(batch, GNN_PAD_MULTIPLE))

    fn = ts.make_train_step(loss, opt_cfg, n_micro=1)
    return StepBundle(
        name="train_step", fn=fn, args=(state, batch), donate_argnums=(0,),
        model_flops_per_step=_gnn_flops(cfg, N, E))


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------

def _recsys_inputs(arch_id: str, cfg, B: int) -> dict[str, Spec]:
    """The inputs of a recsys arch's batch of ``B`` rows: name -> (shape,
    dtype)."""
    i32, f32 = torch.int32, torch.float32
    if arch_id == "dcn-v2":
        return {"dense": ((B, cfg.n_dense), f32),
                "cat": ((B, cfg.n_sparse), i32),
                "label": ((B,), i32)}
    if arch_id == "autoint":
        return {"cat": ((B, cfg.n_sparse), i32),
                "label": ((B,), i32)}
    if arch_id == "dien":
        return {"hist_items": ((B, cfg.seq_len), i32),
                "hist_cates": ((B, cfg.seq_len), i32),
                "hist_mask": ((B, cfg.seq_len), f32),
                "target_item": ((B,), i32),
                "target_cate": ((B,), i32),
                "label": ((B,), i32)}
    if arch_id == "mind":
        return {"hist_items": ((B, cfg.seq_len), i32),
                "hist_mask": ((B, cfg.seq_len), f32),
                "target_item": ((B,), i32)}
    raise ValueError(arch_id)


def _recsys_flops(arch_id: str, cfg, B: int, kind: str) -> float:
    mult = 3.0 if kind == "train" else 1.0
    if arch_id == "dcn-v2":
        d = cfg.d_input
        f = cfg.n_cross_layers * 2 * d * d + 2 * d * cfg.mlp[0] + \
            2 * cfg.mlp[0] * cfg.mlp[1] + 2 * cfg.mlp[1] * cfg.mlp[2]
        return mult * B * f
    if arch_id == "autoint":
        F, dh = cfg.n_sparse, cfg.n_heads * cfg.d_attn
        f = cfg.n_attn_layers * (3 * 2 * F * cfg.embed_dim * dh +
                                 2 * 2 * F * F * dh)
        return mult * B * f
    if arch_id == "dien":
        h = cfg.gru_dim
        f = cfg.seq_len * 2 * 3 * ((cfg.d_behav + h) * h +   # GRU-1
                                   (h + h) * h)              # AUGRU
        return mult * B * f
    if arch_id == "mind":
        if kind == "retrieval":   # interests computed once; per-candidate dot
            return 2.0 * B * cfg.n_interests * cfg.embed_dim
        f = cfg.capsule_iters * 4 * cfg.seq_len * cfg.embed_dim * \
            cfg.n_interests + 2 * cfg.seq_len * cfg.embed_dim ** 2
        return mult * B * f
    raise ValueError(arch_id)


def _recsys_batch(arch_id: str, cfg, B: int, draw: _Draw
                  ) -> dict[str, torch.Tensor]:
    """A batch of ``_recsys_inputs``: each field's ids uniform below its
    vocabulary, dense features N(0, 1), labels Bernoulli(0.5), the
    history mask ``< 0.8`` (as the reduced configs' batches)."""
    vocab = {"hist_items": "item_vocab", "target_item": "item_vocab",
             "hist_cates": "cate_vocab", "target_cate": "cate_vocab"}
    out = {}
    for name, (shape, dtype) in _recsys_inputs(arch_id, cfg, B).items():
        if name == "dense":
            out[name] = draw.normal(shape)
        elif name == "label":
            out[name] = draw.below(shape, 0.5, dtype)
        elif name == "hist_mask":
            out[name] = draw.below(shape, 0.8, dtype)
        elif name == "cat":
            out[name] = draw.ints(shape, list(cfg.vocabs), dtype)
        else:
            out[name] = draw.ints(shape, getattr(cfg, vocab[name]), dtype)
    return out


def item_vocab(arch_id: str, cfg) -> int:
    """The ids a recsys arch's candidates are drawn below: the item
    vocabulary (DCN-v2, AutoInt: the last field's, which the candidate
    replaces)."""
    return cfg.vocabs[-1] if arch_id in ("dcn-v2", "autoint") \
        else cfg.item_vocab


def _recsys_bundle(arch: ArchDef, shape_name: str, cell, draw: _Draw,
                   opt_cfg) -> StepBundle:
    cfg = arch.model_cfg(shape_name)
    mod = arch.module
    aid = arch.arch_id
    if cell["kind"] == "train":
        state = ts.init_state(draw.params(mod, cfg))
        batch = _recsys_batch(aid, cfg, cell["batch"], draw)
        fn = ts.make_train_step(functools.partial(mod.loss_fn, cfg), opt_cfg,
                                n_micro=arch.train_microbatches)
        return StepBundle(
            name="train_step", fn=fn, args=(state, batch),
            donate_argnums=(0,),
            model_flops_per_step=_recsys_flops(aid, cfg, cell["batch"],
                                               "train"))
    params = draw.params(mod, cfg)
    batch = _recsys_batch(aid, cfg, cell["batch"], draw)
    batch.pop("label", None)
    if cell["kind"] == "serve":
        @torch.no_grad()
        def serve_step(params, batch):
            y = mod.forward(cfg, params, batch)
            return y if aid == "mind" else torch.sigmoid(y)

        return StepBundle(
            name="serve_step", fn=serve_step, args=(params, batch),
            model_flops_per_step=_recsys_flops(aid, cfg, cell["batch"],
                                               "serve"))
    # retrieval: 1 query context vs n_candidates item ids
    C = cell["candidates"]
    batch["candidates"] = draw.ints((C,), item_vocab(aid, cfg))

    @torch.no_grad()
    def retrieval_step(params, batch):
        return mod.retrieval_score(cfg, params, batch)

    return StepBundle(
        name="retrieval_step", fn=retrieval_step, args=(params, batch),
        model_flops_per_step=_recsys_flops(aid, cfg, C, "retrieval"))


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def _coerce(val):
    if isinstance(val, str):
        if val.lower() in ("true", "false"):
            return val.lower() == "true"
        if val.isdigit():
            return int(val)
    return val


def _apply_overrides(arch: ArchDef, overrides: dict[str, str]) -> ArchDef:
    """Hillclimb lever: ``attn_impl=flash moe.capacity_factor=...`` applied
    on top of the arch's model config (``dataclasses.replace``; the mesh
    knobs ``sharding_profile`` and ``seq_parallel`` among them), and
    ``train_microbatches`` on the arch.  A key that the config does not
    carry raises, as does a ``moe.`` key on a dense config."""
    if not overrides:
        return arch
    base_fn = arch.model_cfg

    def patched(shape):
        cfg = base_fn(shape)
        fields = {f.name for f in dataclasses.fields(cfg)}
        top, moe_kv = {}, {}
        for key, val in overrides.items():
            if key == "train_microbatches":   # ArchDef-level, not model cfg
                continue
            if key.startswith("moe."):
                if getattr(cfg, "moe", None) is None:
                    raise KeyError(f"override {key!r}: {cfg.name} has no "
                                   f"mixture of experts")
                moe_fields = {f.name for f in dataclasses.fields(cfg.moe)}
                if key[4:] not in moe_fields:
                    raise KeyError(f"override {key!r}: the MoE config has "
                                   f"no field {key[4:]!r} (it has "
                                   f"{sorted(moe_fields)})")
                moe_kv[key[4:]] = _coerce(val)
            elif key in fields:
                top[key] = _coerce(val)
            else:
                raise KeyError(f"override {key!r}: the port's "
                               f"{type(cfg).__name__} has no such field "
                               f"(it has {sorted(fields)})")
        if moe_kv:
            top["moe"] = dataclasses.replace(cfg.moe, **moe_kv)
        return dataclasses.replace(cfg, **top) if top else cfg

    mb = overrides.get("train_microbatches")
    return dataclasses.replace(
        arch, model_cfg=patched,
        train_microbatches=int(mb) if mb else arch.train_microbatches)


def build_bundle(arch_id: str, shape_name: str, *, device=None, mesh=None,
                 opt_cfg: opt_lib.AdamWConfig | None = None,
                 overrides: dict[str, str] | None = None) -> StepBundle:
    """The step of ``arch_id`` at ``shape_name`` with its arguments on
    ``device`` (``None`` = the card, or the mesh's; ``"meta"`` for a dry
    run), on ``mesh`` (None: one card)."""
    arch = get_arch(arch_id)
    if shape_name not in arch.shapes:
        raise KeyError(f"{arch_id} has no shape {shape_name}; "
                       f"known: {sorted(arch.shapes)}")
    arch = _apply_overrides(arch, overrides or {})
    cell = arch.shapes[shape_name]
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    if device is None and mesh is not None and mesh.device is not None:
        device = mesh.device
    device = resolve_device(device)
    if mesh is not None and not mesh.live and device.type != "meta":
        raise ValueError(f"a shape-only mesh ({mesh}) takes tensors on "
                         f"meta, not on {device}")
    if mesh is not None and arch.family != "lm":
        if mesh.size > 1:
            raise WaitsForSlice(
                f"{arch_id} x {shape_name} on a mesh of {mesh.size} cards: "
                f"the zoo on the mesh waits for its slice of the port")
        mesh = None                   # one card
    draw = _Draw(device, mesh)
    if arch.family == "lm":
        if cell["kind"] == "train":
            return _lm_train(arch, cell, draw, opt_cfg)
        return _lm_serve(arch, shape_name, cell, draw)
    if arch.family == "gnn":
        return _gnn_train(arch, shape_name, cell, draw, opt_cfg)
    if arch.family == "recsys":
        return _recsys_bundle(arch, shape_name, cell, draw, opt_cfg)
    raise ValueError(arch.family)
