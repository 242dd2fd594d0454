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
function.  The JAX config's mesh knobs (``sharding_profile``,
``seq_parallel``) have no field here: one card has no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.common import DEFAULT_DTYPE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib


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
    [d_model, vocab], on ``device`` (``None`` = the card).  Made
    uninitialised; :func:`init_params` draws them and
    :func:`lm_from_arrays` copies them in."""

    #: the JAX package stacks these parameters on a leading L axis (its
    #: tree's ``layers``), which the optimizer's weight decay counts
    stacked_prefixes = ("layers.",)

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, dtype=cfg.dtype,
                        device=device), requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_final = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device),
            requires_grad=False)
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab, dtype=cfg.dtype,
                            device=device), requires_grad=False)


def init_params(cfg: LMConfig, generator: torch.Generator) -> TransformerLM:
    """A fresh draw of every weight (the JAX package's ``init_params``
    distribution), on the generator's device; an MoE layer's experts are
    drawn one at a time (``moe_init``)."""
    lm = TransformerLM(cfg, device=generator.device)
    with torch.no_grad():
        lm.embed.copy_(L.dense_init(generator, (cfg.vocab, cfg.d_model),
                                    cfg.dtype, scale=1.0))
        for blk in lm.layers:
            blk.attn = L.attn_init(generator, cfg.attn_dims(), cfg.dtype)
            if cfg.moe:
                blk.moe = moe_lib.moe_init(generator, cfg.d_model, cfg.moe,
                                           cfg.dtype)
            else:
                blk.mlp = L.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                     cfg.dtype)
        if lm.unembed is not None:
            lm.unembed.copy_(L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                          cfg.dtype))
    return lm


def lm_from_arrays(cfg: LMConfig, tree: dict, device=None) -> TransformerLM:
    """The LM whose weights are ``tree``, the JAX ``init_params`` tree with
    numpy (or array-like) leaves, layer leaves stacked on a leading L axis
    (an MoE layer's under ``layers["moe"]``: router, experts and
    ``shared``); each is cast to its parameter's dtype on ``device``
    (``None`` = the card)."""
    lm = TransformerLM(cfg, device=resolve_device(device))

    def put(param, a):
        param.copy_(torch.from_numpy(np.array(a, np.float32)))

    with torch.no_grad():
        put(lm.embed, tree["embed"])
        put(lm.ln_final, tree["ln_final"])
        if lm.unembed is not None:
            put(lm.unembed, tree["unembed"])
        lay = tree["layers"]
        attn_names = ("wq", "wk", "wv", "wo") + \
            (("bq", "bk", "bv") if cfg.qkv_bias else ())
        for i, blk in enumerate(lm.layers):
            for name in attn_names:
                put(getattr(blk.attn, name), lay["attn"][name][i])
            if cfg.moe:
                moe = lay["moe"]
                for name in ("router", "w_gate", "w_up", "w_down"):
                    put(getattr(blk.moe, name), moe[name][i])
                if cfg.moe.n_shared:
                    for name in ("w_gate", "w_up", "w_down"):
                        put(getattr(blk.moe.shared, name),
                            moe["shared"][name][i])
            else:
                for name in ("w_gate", "w_up", "w_down"):
                    put(getattr(blk.mlp, name), lay["mlp"][name][i])
            put(blk.ln_attn, lay["ln_attn"][i])
            put(blk.ln_mlp, lay["ln_mlp"][i])
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

def forward(cfg: LMConfig, lm: TransformerLM, tokens: torch.Tensor, *,
            metrics: list | None = None):
    """Training forward: tokens [B, S] -> (logits [B, S, vocab] in
    ``cfg.dtype``, aux {"moe_aux", "moe_z"}: each summed over the layers;
    empty for a dense LM).  With ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward; its MoE
    metrics are returned from the checkpointed function, so a recompute
    adds none.  Each MoE layer's metrics (``expert_idx`` and the rest) are
    appended to ``metrics`` when that is a list."""
    x = lm.embed.to(cfg.dtype)[tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    memo = {}          # RoPE tables and masks, made once for all layers
    aux = {}
    for blk, chunk in zip(lm.layers, _layer_chunks(cfg)):
        def layer(x, blk=blk, chunk=chunk):
            def attend(attn, h):
                return L.attn_apply(attn, h, positions=positions,
                                    chunk=chunk, impl=cfg.attn_impl,
                                    memo=memo)
            met = []
            return _block(cfg, blk, x, attend, met), met

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
    unembed = lm.embed.T if cfg.tie_embeddings else lm.unembed
    return x @ unembed.to(cfg.dtype), aux


def loss_fn(cfg: LMConfig, lm: TransformerLM, batch: dict, *,
            metrics: list | None = None):
    """Next-token cross-entropy (fp32 logsumexp, the mean over targets
    >= 0) plus the MoE aux losses: (total, {"ce", **aux}).  ``batch``
    holds "tokens" and "targets" [B, S] on the LM's device."""
    logits, aux = forward(cfg, lm, batch["tokens"], metrics=metrics)
    logits = logits.float()
    targets = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    ce = ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
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
           **route) -> torch.Tensor:
    """One transformer layer: x [B, S, d] -> x'; ``attend(attn, h)`` is
    the attention sublayer's output for the normalised ``h``.  An MoE
    layer passes ``route`` (``n_rows``, ``expert_idx``) to
    :func:`~repro_torch.models.moe.moe_apply` and appends its metrics to
    ``metrics`` when that is a list."""
    h = L.rmsnorm(x, p.ln_attn, cfg.norm_eps)
    x = x + attend(p.attn, h)
    h = L.rmsnorm(x, p.ln_mlp, cfg.norm_eps)
    if cfg.moe:
        out, m = moe_lib.moe_apply(p.moe, h, cfg.moe, **route)
        if metrics is not None:
            metrics.append(m)
        return x + out
    return x + L.mlp_apply(p.mlp, h)


def _last_logits(cfg: LMConfig, lm: TransformerLM, x) -> torch.Tensor:
    """Logits [B, vocab] in ``cfg.dtype`` of the last position of x."""
    x = L.rmsnorm(x[:, -1:], lm.ln_final, cfg.norm_eps)
    unembed = lm.embed.T if cfg.tie_embeddings else lm.unembed
    return (x @ unembed.to(cfg.dtype))[:, 0]


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> dict:
    """{"k", "v"}: zeros [n_layers, batch, max_len, n_kv, d_head] on
    ``device`` (``None`` = the card)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    kw = dict(dtype=dtype or cfg.dtype, device=resolve_device(device))
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def _serve_pass(cfg: LMConfig, lm: TransformerLM, tokens: torch.Tensor,
                cache: dict, start_pos: int, n_rows=None,
                metrics: list | None = None):
    """Shared prefill/decode pass: runs tokens [B, S] at absolute offset
    ``start_pos`` against the cache, which it updates in place; returns
    (logits of the last position [B, vocab] in ``cfg.dtype``, cache).
    ``n_rows`` (a 0-d integer tensor on the device; None: B): the first
    rows are the real ones, the rest pad a bucket, and an MoE layer's
    capacity counts the real rows alone; each MoE layer's metrics are
    appended to ``metrics`` when that is a list."""
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
        x = _block(cfg, blk, x, attend, metrics, n_rows=n_rows)
    return _last_logits(cfg, lm, x), cache


def prefill(cfg: LMConfig, lm: TransformerLM, tokens: torch.Tensor,
            cache: dict, *, n_rows=None, metrics: list | None = None):
    """tokens [B, P] at offset 0 -> (logits [B, vocab], cache); ``n_rows``
    and ``metrics`` as in :func:`_serve_pass`."""
    return _serve_pass(cfg, lm, tokens, cache, 0, n_rows, metrics)


def decode_step(cfg: LMConfig, lm: TransformerLM, token: torch.Tensor,
                cache: dict, pos: int, *, n_rows=None,
                metrics: list | None = None):
    """token [B, 1] at absolute position ``pos`` -> (logits, cache); every
    row at one position (:func:`decode_step_ragged` takes a position per
    row); ``n_rows`` and ``metrics`` as in :func:`_serve_pass`."""
    return _serve_pass(cfg, lm, token, cache, pos, n_rows, metrics)


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
