"""Decoder-only GQA transformer LM (the port of
``src/repro/models/transformer_lm.py``: its config, parameters, the
training forward and loss, prefill and decode against a KV cache).

One implementation covers the LMs of the JAX package: the dense ones
(qwen2-1.5b: QKV bias, tied embeddings; glm4-9b, internlm2-1.8b) and the
mixture-of-experts ones (olmoe-1b-7b: 64 experts top-8; llama4-scout:
16 experts top-1 with a shared expert, chunked-local attention on 3 of 4
layers), whose layers hold a ``models/moe.py`` FFN.  The JAX package
stacks layer parameters on a leading ``L`` axis and scans over them; here
:class:`TransformerLM` holds one :class:`Block` per layer and a Python loop
walks them, so a layer's attention chunk is a plain int and each layer
calls ``layers.attn_apply`` (the JAX package's ``_attn_with_traced_chunk``
and ``attn_apply`` are one function here).  The LM prefill runs its
attention on the flash-attention kernel when ``attn_impl="pallas"``, with
the layer's chunk (the JAX package's "pallas" path drops it; the port
computes what its "xla" path does); decode steps stay on the einsum path,
as in the JAX package.  Training (:func:`forward`, :func:`loss_fn`) takes
``attn_impl="flash"``, the kernel under an ``autograd.Function``, or
``"xla"``; with ``remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``, as the JAX package checkpoints its scan
body).  :func:`lm_from_arrays` carries a JAX ``init_params`` tree across
and :func:`lm_to_arrays` carries it back, so both packages compute one
function.

On a mesh of cards (``launch/mesh.py``) the LM is sharded as the
reference shards it: ``sharding_profile`` picks the profile of
``repro_torch/sharding.py`` that maps :func:`param_logical` and
:func:`kv_cache_logical` onto the mesh, each rank holds its shard of every
parameter and of the cache, and :func:`prefill` and :func:`decode_step`
run on the shards (``layers.attn_apply_sharded``,
``layers.mlp_apply_sharded``, ``moe.moe_apply_sharded``, vocab-parallel
embedding and logits), with the collectives of
``repro_torch/collectives.py`` where GSPMD would insert them.
``seq_parallel`` names the residual's sequence axis ``"model"``, as the
reference's layer boundary does; no profile has a rule for that name, so
the residual keeps its sequence whole there too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import collectives as C
from repro_torch import sharding as sh
from repro_torch.common import DEFAULT_DTYPE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.sharding import Ax


@dataclasses.dataclass(frozen=True, kw_only=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_q: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    moe: moe_lib.MoEConfig | None = None
    # per-layer chunked local attention: 0 = all-global; else layers whose
    # index % chunk_every != chunk_every-1 use chunked attention (llama4 iRoPE)
    attn_chunk: int = 0
    attn_chunk_every: int = 4
    # execution knobs
    attn_impl: str = "xla"           # "xla" | "pallas" | "flash"
    remat: bool = True               # recompute each layer in the backward
    sharding_profile: str = "tp"     # a key of sharding.PROFILES
    seq_parallel: bool = False       # name the residual's seq dim 'model'
    dtype: Any = DEFAULT_DTYPE

    @property
    def params_dense(self) -> int:
        """Approximate parameter count excluding MoE experts."""
        d, h = self.d_model, self.d_head
        attn = self.n_layers * d * h * (2 * self.n_q + 2 * self.n_kv)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        mlp = 0 if self.moe else self.n_layers * 3 * d * self.d_ff
        return attn + emb + mlp + 2 * self.n_layers * d

    @property
    def params_total(self) -> int:
        n = self.params_dense
        if self.moe:
            m = self.moe
            n += self.n_layers * m.n_experts * 3 * self.d_model * \
                m.d_ff_expert
            n += self.n_layers * self.d_model * m.n_experts
            if m.n_shared:
                n += self.n_layers * 3 * self.d_model * \
                    (m.d_ff_shared or m.d_ff_expert)
        return n

    @property
    def params_active(self) -> int:
        n = self.params_dense
        if self.moe:
            m = self.moe
            n += self.n_layers * m.top_k * 3 * self.d_model * m.d_ff_expert
            if m.n_shared:
                n += self.n_layers * 3 * self.d_model * \
                    (m.d_ff_shared or m.d_ff_expert)
        return n

    def attn_dims(self) -> L.AttnDims:
        return L.AttnDims(d_model=self.d_model, n_q=self.n_q, n_kv=self.n_kv,
                          d_head=self.d_head, qkv_bias=self.qkv_bias,
                          rope_theta=self.rope_theta)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One transformer layer's parameters, on ``device`` (``None`` = the
    card): ``attn``, then ``moe`` (a :class:`~repro_torch.models.moe.MoE`)
    with ``cfg.moe``, else ``mlp``."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.attn = L.Attention(cfg.attn_dims(), cfg.dtype, device)
        if cfg.moe:
            self.moe = moe_lib.MoE(cfg.d_model, cfg.moe, cfg.dtype, device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device)
        self.ln_attn = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device),
            requires_grad=False)
        self.ln_mlp = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device),
            requires_grad=False)


class TransformerLM(nn.Module):
    """The LM's parameters: ``embed`` [vocab, d_model], one :class:`Block`
    per layer, ``ln_final`` and, without tied embeddings, ``unembed``
    [d_model, vocab], on ``device`` (``None`` = the card, or the mesh's
    device).  Made uninitialised; :func:`init_params` draws them and
    :func:`lm_from_arrays` copies them in.

    With ``mesh`` each parameter is the rank's shard, of the shape its
    spec gives (:func:`param_specs`; a layer's spec without the stacked
    L dim), and each module keeps its parameters' specs in
    ``shard_specs``; ``mesh`` is kept as ``lm.mesh`` (None without)."""

    #: the JAX package stacks these parameters on a leading L axis (its
    #: tree's ``layers``), which the optimizer's weight decay counts
    stacked_prefixes = ("layers.",)

    def __init__(self, cfg: LMConfig, device=None, mesh=None):
        super().__init__()
        if device is None and mesh is not None and mesh.device is not None:
            device = mesh.device
        device = resolve_device(device)
        # on a mesh: made on meta at full size, then each parameter is
        # replaced by its shard
        at = torch.device("meta") if mesh is not None else device
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, dtype=cfg.dtype,
                        device=at), requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, at)
                                    for _ in range(cfg.n_layers))
        self.ln_final = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=at),
            requires_grad=False)
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab, dtype=cfg.dtype,
                            device=at), requires_grad=False)
        self.mesh = mesh
        if mesh is not None:
            self._shard(cfg, mesh, device)

    def _shard(self, cfg: LMConfig, mesh, device) -> None:
        tree = param_specs(cfg, mesh)
        for name, p in list(self.named_parameters()):
            spec = _leaf_spec(tree, name)
            owner_name, _, leaf = name.rpartition(".")
            owner = self.get_submodule(owner_name)
            shape = sh.local_shape(spec, p.shape, mesh)
            make = torch.ones if leaf.startswith("ln") else torch.empty
            setattr(owner, leaf, nn.Parameter(
                make(shape, dtype=p.dtype, device=device),
                requires_grad=False))
            if "shard_specs" not in owner.__dict__:
                owner.shard_specs = {}
            owner.shard_specs[leaf] = spec

    def spec(self, name: str):
        """The spec of the parameter ``name`` (a dotted parameter name)."""
        owner_name, _, leaf = name.rpartition(".")
        return self.get_submodule(owner_name).shard_specs[leaf]


def _tree_path(name: str) -> tuple[list[str], bool]:
    """A dotted parameter name -> (its path in the JAX tree, whether the
    tree stacks it on L): ``layers.3.attn.wq`` -> (layers/attn/wq, True)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ["layers", *parts[2:]], True
    return parts, False


def _leaf_spec(tree: dict, name: str):
    """The spec of parameter ``name`` in a tree of specs of the stacked
    JAX tree (a layer's without its L dim)."""
    path, stacked = _tree_path(name)
    node = tree
    for part in path:
        node = node[part]
    return sh.P(*node[1:]) if stacked else node


def param_shapes(cfg: LMConfig) -> dict:
    """The shape of every leaf of the JAX ``init_params`` tree (layer
    leaves stacked on a leading L dim)."""
    n, d, h = cfg.n_layers, cfg.d_model, cfg.d_head
    attn = {"wq": (n, d, cfg.n_q, h), "wk": (n, d, cfg.n_kv, h),
            "wv": (n, d, cfg.n_kv, h), "wo": (n, cfg.n_q, h, d)}
    if cfg.qkv_bias:
        attn |= {"bq": (n, cfg.n_q, h), "bk": (n, cfg.n_kv, h),
                 "bv": (n, cfg.n_kv, h)}
    layer = {"attn": attn, "ln_attn": (n, d), "ln_mlp": (n, d)}
    if cfg.moe:
        m = cfg.moe
        E, f = m.n_experts, m.d_ff_expert
        layer["moe"] = {"router": (n, d, E), "w_gate": (n, E, d, f),
                        "w_up": (n, E, d, f), "w_down": (n, E, f, d)}
        if m.n_shared:
            fs = m.d_ff_shared or f
            layer["moe"]["shared"] = {"w_gate": (n, d, fs),
                                      "w_up": (n, d, fs),
                                      "w_down": (n, fs, d)}
    else:
        layer["mlp"] = {"w_gate": (n, d, cfg.d_ff), "w_up": (n, d, cfg.d_ff),
                        "w_down": (n, cfg.d_ff, d)}
    tree = {"embed": (cfg.vocab, d), "layers": layer, "ln_final": (d,)}
    if not cfg.tie_embeddings:
        tree["unembed"] = (d, cfg.vocab)
    return tree


def param_logical(cfg: LMConfig) -> dict[str, Any]:
    """Logical-axis tree mirroring :func:`param_shapes` (the reference's
    ``param_logical``)."""
    attn = {
        "wq": Ax(None, sh.EMBED, sh.Q_HEADS, sh.HEAD_DIM),
        "wk": Ax(None, sh.EMBED, sh.KV_HEADS, sh.HEAD_DIM),
        "wv": Ax(None, sh.EMBED, sh.KV_HEADS, sh.HEAD_DIM),
        "wo": Ax(None, sh.Q_HEADS, sh.HEAD_DIM, sh.EMBED),
    }
    if cfg.qkv_bias:
        attn |= {"bq": Ax(None, sh.Q_HEADS, sh.HEAD_DIM),
                 "bk": Ax(None, sh.KV_HEADS, sh.HEAD_DIM),
                 "bv": Ax(None, sh.KV_HEADS, sh.HEAD_DIM)}
    layer = {"attn": attn,
             "ln_attn": Ax(None, None), "ln_mlp": Ax(None, None)}
    if cfg.moe:
        layer["moe"] = {
            "router": Ax(None, sh.EMBED, None),
            "w_gate": Ax(None, sh.EXPERTS, sh.EMBED, sh.MLP),
            "w_up": Ax(None, sh.EXPERTS, sh.EMBED, sh.MLP),
            "w_down": Ax(None, sh.EXPERTS, sh.MLP, sh.EMBED),
        }
        if cfg.moe.n_shared:
            layer["moe"]["shared"] = {
                "w_gate": Ax(None, sh.EMBED, sh.MLP),
                "w_up": Ax(None, sh.EMBED, sh.MLP),
                "w_down": Ax(None, sh.MLP, sh.EMBED),
            }
    else:
        layer["mlp"] = {"w_gate": Ax(None, sh.EMBED, sh.MLP),
                        "w_up": Ax(None, sh.EMBED, sh.MLP),
                        "w_down": Ax(None, sh.MLP, sh.EMBED)}
    tree = {"embed": Ax(sh.VOCAB, sh.EMBED),
            "layers": layer,
            "ln_final": Ax(None)}
    if not cfg.tie_embeddings:
        tree["unembed"] = Ax(sh.EMBED, sh.VOCAB)
    return tree


def kv_cache_logical() -> dict:
    return {"k": Ax(None, sh.BATCH, sh.KV_SEQ, sh.KV_HEADS, None),
            "v": Ax(None, sh.BATCH, sh.KV_SEQ, sh.KV_HEADS, None)}


def profile(cfg: LMConfig, mesh) -> dict:
    """The sharding profile ``cfg.sharding_profile`` on ``mesh``."""
    if cfg.sharding_profile not in sh.PROFILES:
        raise KeyError(f"sharding_profile {cfg.sharding_profile!r}: known "
                       f"{sorted(sh.PROFILES)}")
    return sh.PROFILES[cfg.sharding_profile](mesh)


def param_specs(cfg: LMConfig, mesh) -> dict:
    """The spec of every leaf of :func:`param_shapes` on ``mesh``."""
    return sh.pspec_tree(param_shapes(cfg), param_logical(cfg), mesh,
                         profile(cfg, mesh))


def state_specs(cfg: LMConfig, mesh) -> dict:
    """The reference's shardings of a train state on ``mesh`` (its
    ``_abstract_state``): the parameters by :func:`param_specs`, the
    moments by ``zero1_sharding_tree`` of them, the step replicated."""
    pspecs = param_specs(cfg, mesh)
    moments = sh.zero1_sharding_tree(param_shapes(cfg), pspecs, mesh)
    return {"params": pspecs,
            "opt": {"m": moments, "v": moments, "step": sh.P()}}


def init_params(cfg: LMConfig, generator: torch.Generator,
                mesh=None) -> TransformerLM:
    """A fresh draw of every weight (the JAX package's ``init_params``
    distribution), on the generator's device, one leaf at a time: the
    embedding, then a layer's wq, wk, wv, wo (biases zero), and its
    router and experts (an expert at a time, as ``moe_init`` draws them)
    or its MLP, then the unembedding.  With ``mesh`` each leaf is drawn
    whole and cut to the rank's shard: every rank's shards are slices of
    the one-card draw from the same seed, and no rank holds more than one
    whole leaf."""
    lm = TransformerLM(cfg, device=generator.device, mesh=mesh)
    d, h = cfg.d_model, cfg.d_head

    def put(name, full, expert=None):
        _put(lm, name, full, mesh, expert)

    def draw(shape, dtype=cfg.dtype, scale=None):
        return L.dense_init(generator, shape, dtype, scale)

    with torch.no_grad():
        put("embed", draw((cfg.vocab, d), scale=1.0))
        for i, blk in enumerate(lm.layers):
            at = f"layers.{i}."
            for name, shape in (("wq", (d, cfg.n_q, h)),
                                ("wk", (d, cfg.n_kv, h)),
                                ("wv", (d, cfg.n_kv, h)),
                                ("wo", (cfg.n_q, h, d))):
                put(at + "attn." + name, draw(shape))
            if cfg.qkv_bias:
                for name in ("bq", "bk", "bv"):
                    getattr(blk.attn, name).zero_()
            if cfg.moe:
                m = cfg.moe
                f = m.d_ff_expert
                put(at + "moe.router", draw((d, m.n_experts), torch.float32))
                for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                                    ("w_down", (f, d))):
                    for e in range(m.n_experts):
                        put(at + "moe." + name,
                            draw(shape, scale=m.n_experts ** -0.5), e)
                if m.n_shared:
                    fs = m.d_ff_shared or f
                    for name, shape in (("w_gate", (d, fs)),
                                        ("w_up", (d, fs)),
                                        ("w_down", (fs, d))):
                        put(at + "moe.shared." + name, draw(shape))
            else:
                for name, shape in (("w_gate", (d, cfg.d_ff)),
                                    ("w_up", (d, cfg.d_ff)),
                                    ("w_down", (cfg.d_ff, d))):
                    put(at + "mlp." + name, draw(shape))
        if lm.unembed is not None:
            put("unembed", draw((d, cfg.vocab)))
    return lm


def _put(lm: TransformerLM, name: str, full, mesh, expert=None) -> None:
    """Copy ``full``, the whole leaf of parameter ``name`` (of its expert
    ``expert`` alone when given), into ``lm``: whole without ``mesh``, else
    the rank's slice of it by the parameter's spec (an expert another rank
    holds is skipped)."""
    p = lm.get_parameter(name)
    if mesh is None:
        (p if expert is None else p[expert]).copy_(full)
        return
    spec = lm.spec(name)
    if expert is not None:
        e = expert - sh.shard_index(mesh, sh.spec_axes(spec, 0),
                                    mesh.coords) * p.shape[0]
        if not 0 <= e < p.shape[0]:
            return
        p, spec = p[e], sh.P(*spec[1:])
    p.copy_(full[sh.local_slices(spec, full.shape, mesh, mesh.coords)])


def lm_from_arrays(cfg: LMConfig, tree: dict, device=None,
                   mesh=None) -> TransformerLM:
    """The LM whose weights are ``tree``, the JAX ``init_params`` tree with
    numpy (or array-like) leaves, layer leaves stacked on a leading L axis
    (an MoE layer's under ``layers["moe"]``: router, experts and
    ``shared``); each is cast to its parameter's dtype on ``device``
    (``None`` = the card, or the mesh's).  With ``mesh`` each parameter
    takes the rank's slice of its leaf."""
    lm = TransformerLM(cfg, device=device, mesh=mesh)
    with torch.no_grad():
        for name, _ in lm.named_parameters():
            path, stacked = _tree_path(name)
            a = tree
            for part in path:
                a = a[part]
            a = np.asarray(a)
            if stacked:
                a = a[int(name.split(".")[1])]
            _put(lm, name, torch.from_numpy(np.array(a, np.float32)), mesh)
    return lm


def lm_to_arrays(cfg: LMConfig, lm: TransformerLM) -> dict:
    """The JAX ``init_params`` tree of ``lm``'s weights as float32 numpy
    arrays, each layer leaf stacked on a leading L axis (the inverse of
    :func:`lm_from_arrays`)."""
    tree: dict = {}
    for name, p in lm.named_parameters():
        *path, leaf = name.split(".")
        a = p.detach().float().cpu().numpy()
        if path[:1] == ["layers"]:
            i, path = int(path[1]), ["layers", *path[2:]]
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if path[:1] == ["layers"]:
            node.setdefault(leaf, [None] * cfg.n_layers)[i] = a
        else:
            node[leaf] = a

    def stack(node):
        return {k: np.stack(v) if isinstance(v, list) else
                (stack(v) if isinstance(v, dict) else v)
                for k, v in node.items()}

    return stack(tree)


# ---------------------------------------------------------------------------
# the training forward and loss
# ---------------------------------------------------------------------------

def train_specs(cfg: LMConfig, mesh, rows: int, seq: int) -> dict:
    """The reference's shardings of a training pass over a batch of
    ``rows`` x ``seq`` tokens on ``mesh``: its tokens and targets
    ``(BATCH, None)``, its logits ``(BATCH, None, VOCAB)`` (the constraint
    of its ``forward``) and its residual ``(BATCH, "model" if
    seq_parallel else None, None)`` (its layer boundary's)."""
    prof = profile(cfg, mesh)
    return {
        "tokens": sh.resolve_spec((sh.BATCH, None), (rows, seq), mesh, prof),
        "logits": sh.resolve_spec((sh.BATCH, None, sh.VOCAB),
                                  (rows, seq, cfg.vocab), mesh, prof),
        "residual": sh.resolve_spec(
            (sh.BATCH, "model" if cfg.seq_parallel else None, None),
            (rows, seq, cfg.d_model), mesh, prof),
    }


def shard_batch(cfg: LMConfig, mesh, batch: dict, n_micro: int = 1
                ) -> dict:
    """The rank's share of a whole training batch (tensors [B, ...]) on
    ``mesh`` for a step of ``n_micro`` micro-batches: micro-batch i is the
    batch's rows [i B/n, (i+1) B/n), the reference's split of the global
    batch, of which the rank takes its rows by :func:`train_specs` of a
    micro-batch; the shares follow each other in micro-batch order, so the
    step's split of the rank's rows gives each micro-batch's share.
    ``"rows"`` is B."""
    B, S = batch["tokens"].shape[:2]
    b = B // n_micro
    rows = sh.local_slices(train_specs(cfg, mesh, b, S)["tokens"], (b, S),
                           mesh, mesh.coords)[0]
    out = {k: torch.cat([v[i * b:(i + 1) * b][rows]
                         for i in range(n_micro)])
           for k, v in batch.items()}
    out["rows"] = B
    return out


def _train_axes(cfg: LMConfig, mesh, tokens, rows) -> tuple:
    """(token axes, vocab axes) of a training pass on ``mesh`` whose
    tokens [B_l, S] are the rank's rows of a batch of ``rows``."""
    if rows is None:
        raise ValueError("a training pass on a mesh needs rows=, the whole "
                         "batch's row count")
    specs = train_specs(cfg, mesh, rows, tokens.shape[1])
    tok = sh.spec_axes(specs["tokens"], 0)
    if tokens.shape[0] * math.prod(mesh.shape[a] for a in tok) != rows:
        raise ValueError(f"{tokens.shape[0]} rows a rank over {tok} are "
                         f"not the batch's {rows}")
    if sh.spec_axes(specs["residual"], 1):
        raise NotImplementedError(f"a residual sharded as "
                                  f"{specs['residual']}")
    return tok, sh.spec_axes(specs["logits"], 2)


def forward(cfg: LMConfig, lm: TransformerLM, tokens: torch.Tensor, *,
            metrics: list | None = None, mesh=None, rows: int | None = None,
            expert_idx: list | None = None):
    """Training forward: tokens [B, S] -> (logits [B, S, vocab] in
    ``cfg.dtype``, aux {"moe_aux", "moe_z"}: each summed over the layers;
    empty for a dense LM).  With ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward (on a
    mesh with its collectives, as the reference's ``nothing_saveable``
    recomputes its gathers); its MoE metrics are returned from the
    checkpointed function, so a recompute adds none.  Each MoE layer's
    metrics (``expert_idx`` and the rest) are appended to ``metrics`` when
    that is a list; ``expert_idx`` (one [B * S, k] tensor an MoE layer,
    the whole batch's even on a mesh) pins each layer's routing, as
    ``moe_apply`` takes it.

    On the LM's mesh (``mesh`` None or the same) ``tokens`` are the rank's
    rows of a batch of ``rows`` rows, by :func:`train_specs`: the residual
    stays ``(BATCH, None, None)``, the layers run on the rank's shards as
    a prefill does, without a cache, and the logits come out as the rank's
    shard [B_l, S, vocab_l] of ``(BATCH, None, VOCAB)``; differentiable
    (``collectives.py``)."""
    mesh = _mesh_of(lm, mesh)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    memo = {}          # RoPE tables and masks, made once for all layers
    if mesh is None:
        tok = ()
        x = lm.embed.to(cfg.dtype)[tokens.long()]

        def attend(attn, h, chunk):
            return L.attn_apply(attn, h, positions=positions, chunk=chunk,
                                impl=cfg.attn_impl, memo=memo)
    else:
        tok, vax = _train_axes(cfg, mesh, tokens, rows)
        x = L.embed_lookup(lm.embed, lm.spec("embed"), tokens, mesh, tok,
                           cfg.dtype)

        def attend(attn, h, chunk):
            return L.attn_apply_sharded(
                attn, h, positions=positions, chunk=chunk,
                impl=cfg.attn_impl, mesh=mesh, token_axes=tok, memo=memo)
    aux = {}
    for i, (blk, chunk) in enumerate(zip(lm.layers, _layer_chunks(cfg))):
        def layer(x, blk=blk, chunk=chunk,
                  pin=expert_idx[i] if expert_idx else None):
            met = []
            return _block(cfg, blk, x,
                          lambda attn, h: attend(attn, h, chunk), met,
                          mesh=mesh, token_axes=tok, expert_idx=pin), met

        if cfg.remat:
            x, met = torch.utils.checkpoint.checkpoint(layer, x,
                                                       use_reentrant=False)
        else:
            x, met = layer(x)
        for m in met:
            for key in ("moe_aux", "moe_z"):
                aux[key] = aux[key] + m[key] if key in aux else m[key]
            if metrics is not None:
                metrics.append(m)
    x = L.rmsnorm(x, lm.ln_final, cfg.norm_eps)
    if mesh is None:
        unembed = lm.embed.T if cfg.tie_embeddings else lm.unembed
        return x @ unembed.to(cfg.dtype), aux
    name, vdim = ("embed", 0) if cfg.tie_embeddings else ("unembed", 1)
    logits, got = L.vocab_logits(x, lm.get_parameter(name), lm.spec(name),
                                 vdim, mesh, tok, cfg.dtype)
    if got != vax:
        raise NotImplementedError(f"logits over vocab axes {got} where the "
                                  f"reference shards them over {vax}")
    return logits, aux


def loss_fn(cfg: LMConfig, lm: TransformerLM, batch: dict, *,
            metrics: list | None = None, mesh=None,
            expert_idx: list | None = None):
    """Next-token cross-entropy (fp32 logsumexp, the mean over targets
    >= 0) plus the MoE aux losses: (total, {"ce", **aux}).  ``batch``
    holds "tokens" and "targets" [B, S] on the LM's device.

    On the LM's mesh they are the rank's rows and ``batch["rows"]`` the
    whole batch's row count (:func:`forward`); the cross-entropy is
    vocab-parallel over the logits' shards: the logsumexp's maximum and
    sum, and each row's gold logit (taken on the rank that holds it), are
    reduced over the vocab axes, and ``ce`` is the sum over the batch axes
    over their count of targets.  Every rank's total is the whole batch's
    loss.  ``metrics`` and ``expert_idx`` as in :func:`forward`."""
    mesh = _mesh_of(lm, mesh)
    rows = batch.get("rows")
    logits, aux = forward(cfg, lm, batch["tokens"], metrics=metrics,
                          mesh=mesh, rows=rows, expert_idx=expert_idx)
    logits = logits.float()
    targets = batch["targets"].long()
    mask = (targets >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    if mesh is None:
        gold = logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        ce = ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
        return ce + sum(aux.values(), 0.0), {"ce": ce, **aux}
    tok, vax = _train_axes(cfg, mesh, batch["tokens"], rows)
    V_l = logits.shape[-1]
    t = targets - L._offset(mesh, vax, V_l)
    mine = (t >= 0) & (t < V_l)
    gold = torch.where(mine, logits.gather(
        -1, t.clamp(0, V_l - 1)[..., None])[..., 0], 0.0)
    if vax:
        top = C.all_reduce(logz.detach().clone(), mesh, vax, "max")
        logz = top + torch.log(C.all_reduce(torch.exp(logz - top), mesh,
                                            vax))
        gold = C.all_reduce(gold, mesh, vax)
    total = C.all_reduce(((logz - gold) * mask).sum(), mesh, tok)
    ce = total / C.all_reduce(mask.sum(), mesh, tok).clamp_min(1.0)
    return ce + sum(aux.values(), 0.0), {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode against a stacked KV cache
# ---------------------------------------------------------------------------

def _layer_chunks(cfg: LMConfig) -> list[int]:
    """Per-layer attention chunk size (0 = global attention)."""
    if not cfg.attn_chunk:
        return [0] * cfg.n_layers
    every = cfg.attn_chunk_every
    return [cfg.attn_chunk if i % every != every - 1 else 0
            for i in range(cfg.n_layers)]


def _block(cfg: LMConfig, p: Block, x, attend, metrics: list | None = None,
           mesh=None, token_axes=(), **route) -> torch.Tensor:
    """One transformer layer: x [B, S, d] -> x'; ``attend(attn, h)`` is
    the attention sublayer's output for the normalised ``h``.  An MoE
    layer passes ``route`` (``n_rows``, ``expert_idx``) to
    :func:`~repro_torch.models.moe.moe_apply` and appends its metrics to
    ``metrics`` when that is a list.  With ``mesh`` the FFN runs on the
    rank's shards, x being its rows (sharded over ``token_axes``)."""
    h = L.rmsnorm(x, p.ln_attn, cfg.norm_eps)
    x = x + attend(p.attn, h)
    h = L.rmsnorm(x, p.ln_mlp, cfg.norm_eps)
    if cfg.moe:
        if mesh is None:
            out, m = moe_lib.moe_apply(p.moe, h, cfg.moe, **route)
        else:
            out, m = moe_lib.moe_apply_sharded(p.moe, h, cfg.moe, mesh,
                                               token_axes, **route)
        if metrics is not None:
            metrics.append(m)
        return x + out
    if mesh is None:
        return x + L.mlp_apply(p.mlp, h)
    return x + L.mlp_apply_sharded(p.mlp, h, mesh, token_axes)


def _last_logits(cfg: LMConfig, lm: TransformerLM, x) -> torch.Tensor:
    """Logits [B, vocab] in ``cfg.dtype`` of the last position of x."""
    x = L.rmsnorm(x[:, -1:], lm.ln_final, cfg.norm_eps)
    unembed = lm.embed.T if cfg.tie_embeddings else lm.unembed
    return (x @ unembed.to(cfg.dtype))[:, 0]


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  device=None, mesh=None) -> dict:
    """{"k", "v"}: zeros [n_layers, batch, max_len, n_kv, d_head] on
    ``device`` (``None`` = the card).  With ``mesh``: the rank's shards
    of them, by :func:`cache_spec`, and under "shape" the whole cache's
    shape, from which a pass on the mesh reads its layout."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    if mesh is not None:
        if device is None and mesh.device is not None:
            device = mesh.device
        local = sh.local_shape(cache_spec(cfg, mesh, shape), shape, mesh)
        kw = dict(dtype=dtype or cfg.dtype, device=resolve_device(device))
        return {"k": torch.zeros(local, **kw), "v": torch.zeros(local, **kw),
                "shape": shape}
    kw = dict(dtype=dtype or cfg.dtype, device=resolve_device(device))
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def cache_spec(cfg: LMConfig, mesh, shape) -> sh.P:
    """The spec of a KV cache of ``shape`` (k's and v's alike)."""
    return sh.resolve_spec(kv_cache_logical()["k"].names, shape, mesh,
                           profile(cfg, mesh))


def serve_specs(cfg: LMConfig, mesh, batch: int, seq: int,
                cache_len: int) -> dict:
    """The reference's shardings of a serve step's tokens [batch, seq],
    cache, logits [batch, vocab] and residual [batch, seq, d_model] (its
    layer boundary's ``(BATCH, "model" if seq_parallel else None,
    None)``) on ``mesh``."""
    prof = profile(cfg, mesh)
    return {
        "tokens": sh.resolve_spec((sh.BATCH, None), (batch, seq), mesh, prof),
        "cache": cache_spec(cfg, mesh, (cfg.n_layers, batch, cache_len,
                                        cfg.n_kv, cfg.d_head)),
        "logits": sh.resolve_spec((sh.BATCH, sh.VOCAB), (batch, cfg.vocab),
                                  mesh, prof),
        "residual": sh.resolve_spec(
            (sh.BATCH, "model" if cfg.seq_parallel else None, None),
            (batch, seq, cfg.d_model), mesh, prof),
    }


def _mesh_of(lm: TransformerLM, mesh):
    """The mesh a pass runs on: the one the LM's shards were cut for."""
    held = getattr(lm, "mesh", None)
    if mesh is not None and mesh is not held:
        raise ValueError(f"the LM's parameters are sharded for {held}, "
                         f"not for {mesh}")
    return held


def _serve_pass_sharded(cfg: LMConfig, lm: TransformerLM, tokens, cache,
                        start_pos: int, metrics: list | None = None,
                        expert_idx: list | None = None):
    """:func:`_serve_pass` on ``lm.mesh``: tokens [B_l, S] and the cache
    are the rank's shards (the cache's whole shape under "shape"); the
    logits come out as the rank's shard [B_l, vocab_l] of the reference's
    ``(BATCH, VOCAB)``."""
    mesh = lm.mesh
    S = tokens.shape[1]
    B, T = cache["shape"][1:3]
    specs = serve_specs(cfg, mesh, B, S, T)
    tok_axes = sh.spec_axes(specs["tokens"], 0)
    cspec = specs["cache"]
    if sh.spec_axes(cspec, 1) != tok_axes or any(
            sh.spec_axes(cspec, i) for i in (0, 3, 4)):
        raise NotImplementedError(f"a cache sharded as {cspec} beside tokens "
                                  f"as {specs['tokens']}")
    # the six profiles have no rule for the residual's "model": its
    # sequence stays whole, as at the reference's layer boundary
    if sh.spec_axes(specs["residual"], 1):
        raise NotImplementedError(f"a residual sharded as "
                                  f"{specs['residual']}")
    seq_axes = sh.spec_axes(cspec, 2)
    x = L.embed_lookup(lm.embed, lm.spec("embed"), tokens, mesh, tok_axes,
                       cfg.dtype)
    positions = start_pos + torch.arange(S, device=tokens.device)
    memo = {}          # RoPE tables and masks, made once for all layers
    for i, (blk, chunk) in enumerate(zip(lm.layers, _layer_chunks(cfg))):
        def attend(attn, h, i=i, chunk=chunk):
            return L.attn_apply_sharded(
                attn, h, positions=positions,
                kv_cache=(cache["k"][i], cache["v"][i]),
                cache_index=start_pos, chunk=chunk, impl=cfg.attn_impl,
                mesh=mesh, token_axes=tok_axes, seq_axes=seq_axes, memo=memo)
        x = _block(cfg, blk, x, attend, metrics, mesh=mesh,
                   token_axes=tok_axes,
                   expert_idx=expert_idx[i] if expert_idx else None)
    x = L.rmsnorm(x[:, -1], lm.ln_final, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits, vax = L.vocab_logits(x, lm.embed, lm.spec("embed"), 0, mesh,
                                     tok_axes, cfg.dtype)
    else:
        logits, vax = L.vocab_logits(x, lm.unembed, lm.spec("unembed"), 1,
                                     mesh, tok_axes, cfg.dtype)
    want = specs["logits"]
    if (sh.spec_axes(want, 0), sh.spec_axes(want, 1)) != (tok_axes, vax):
        raise NotImplementedError(f"logits as ({tok_axes}, {vax}) where the "
                                  f"reference lays them out as {want}")
    return logits, cache


def _serve_pass(cfg: LMConfig, lm: TransformerLM, tokens: torch.Tensor,
                cache: dict, start_pos: int, n_rows=None,
                metrics: list | None = None, mesh=None,
                expert_idx: list | None = None):
    """Shared prefill/decode pass: runs tokens [B, S] at absolute offset
    ``start_pos`` against the cache, which it updates in place; returns
    (logits of the last position [B, vocab] in ``cfg.dtype``, cache).
    ``n_rows`` (a 0-d integer tensor on the device; None: B): the first
    rows are the real ones, the rest pad a bucket, and an MoE layer's
    capacity counts the real rows alone; each MoE layer's metrics are
    appended to ``metrics`` when that is a list.  ``expert_idx`` (one
    [B * S, k] tensor an MoE layer, the whole batch's even on a mesh) pins
    each layer's routing, as ``moe_apply`` takes it.  On a mesh (the LM's,
    ``mesh`` None or the same) see :func:`_serve_pass_sharded`."""
    if _mesh_of(lm, mesh) is not None:
        if n_rows is not None:
            raise NotImplementedError("n_rows on a mesh")
        return _serve_pass_sharded(cfg, lm, tokens, cache, start_pos,
                                   metrics, expert_idx)
    S = tokens.shape[1]
    x = lm.embed.to(cfg.dtype)[tokens.long()]
    positions = start_pos + torch.arange(S, device=tokens.device)
    memo = {}          # RoPE tables and masks, made once for all layers
    for i, (blk, chunk) in enumerate(zip(lm.layers, _layer_chunks(cfg))):
        def attend(attn, h, i=i, chunk=chunk):
            return L.attn_apply(attn, h, positions=positions,
                                kv_cache=(cache["k"][i], cache["v"][i]),
                                cache_index=start_pos, chunk=chunk,
                                impl=cfg.attn_impl, memo=memo)
        x = _block(cfg, blk, x, attend, metrics, n_rows=n_rows,
                   expert_idx=expert_idx[i] if expert_idx else None)
    return _last_logits(cfg, lm, x), cache


def prefill(cfg: LMConfig, lm: TransformerLM, tokens: torch.Tensor,
            cache: dict, *, n_rows=None, metrics: list | None = None,
            mesh=None, expert_idx: list | None = None):
    """tokens [B, P] at offset 0 -> (logits [B, vocab], cache); ``n_rows``,
    ``metrics``, ``mesh`` and ``expert_idx`` as in :func:`_serve_pass`."""
    return _serve_pass(cfg, lm, tokens, cache, 0, n_rows, metrics, mesh,
                       expert_idx)


def decode_step(cfg: LMConfig, lm: TransformerLM, token: torch.Tensor,
                cache: dict, pos: int, *, n_rows=None,
                metrics: list | None = None, mesh=None,
                expert_idx: list | None = None):
    """token [B, 1] at absolute position ``pos`` -> (logits, cache); every
    row at one position (:func:`decode_step_ragged` takes a position per
    row); ``n_rows``, ``metrics``, ``mesh`` and ``expert_idx`` as in
    :func:`_serve_pass`."""
    return _serve_pass(cfg, lm, token, cache, pos, n_rows, metrics, mesh,
                       expert_idx)


def decode_step_ragged(cfg: LMConfig, lm: TransformerLM, tokens: torch.Tensor,
                       cache: dict, positions: torch.Tensor):
    """tokens [B, 1], each row at its own absolute position ``positions``
    [B] (a device tensor) -> (logits [B, vocab], cache): the decode pool's
    step, whose slots sit at different depths.  Each row's k and v are
    scattered into the cache at its position, in place, and its attention
    reads the cache up to that position, within the layer's chunk as
    :func:`decode_step` reads it (the JAX package's ragged decode,
    ``serve/batching.py``, drops the chunk: ROADMAP §3); the einsum path.
    An MoE layer routes every row, idle slots' included, as the JAX
    package's step does: capacity is per call.  No value leaves the
    device, so the step can be captured as a CUDA graph."""
    B = tokens.shape[0]
    pos = positions.long()
    x = lm.embed.to(cfg.dtype)[tokens.long()]
    rope = L.rope_cos_sin(pos[:, None], cfg.d_head, cfg.rope_theta)
    T = cache["k"].shape[2]
    k_pos = torch.arange(T, device=pos.device)[None, :]
    biases = {}                 # chunk -> [B, 1, 1, 1, T], made once

    def bias(chunk):
        if chunk not in biases:
            ok = k_pos <= pos[:, None]
            if chunk:
                ok &= (k_pos // chunk) == (pos[:, None] // chunk)
            biases[chunk] = torch.where(ok, 0.0, L.NEG_INF)[
                :, None, None, None, :]
        return biases[chunk]

    at = pos[:, None, None, None].expand(B, 1, cfg.n_kv, cfg.d_head)
    for i, (blk, chunk) in enumerate(zip(lm.layers, _layer_chunks(cfg))):
        def attend(attn, h, i=i, chunk=chunk):
            q, k, v = attn.project(h, pos[:, None], rope)
            ck, cv = cache["k"][i], cache["v"][i]
            ck.scatter_(1, at, k.to(ck.dtype))
            cv.scatter_(1, at, v.to(cv.dtype))
            return attn.out(L.gqa_attention(q, ck, cv, bias(chunk),
                                            impl="xla"))
        x = _block(cfg, blk, x, attend)
    return _last_logits(cfg, lm, x), cache
