"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
(data sheet, dense rates, 700 W), the operations and bytes of each hand
kernel a cell's roofline reads (inputs read once, outputs written once),
and the model flops of an LM step.  The kernels' formulas are copies of
the program's own cost functions, kept here so that the program cannot
move them."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # outside the tensor cores
BF16_FLOPS = 989e12          # dense tensor cores

#: fp32 operations per posting of each weighting model, as counted from
#: the model lines of the fused-scoring kernel
MODEL_OPS = {"BM25": 12, "TF_IDF": 8, "QL": 12, "DPH": 23, "Coord": 1}


def least_time(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least seconds the chip could take: the larger of operations at
    ``peak_flops`` and bytes at the HBM rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def fused_scoring_cost(n_postings: int, row_stats: int,
                       models) -> tuple[float, float]:
    """One fused-scoring call over ``n_postings`` postings as handed to
    the kernel (tf and dl, int32 each), ``row_stats`` rows of (df, cf) as
    int32, one float32 score a posting and model written."""
    ops = n_postings * sum(MODEL_OPS[m] for m in models)
    nbytes = n_postings * 8 + row_stats * 8 + n_postings * len(models) * 4
    return float(ops), float(nbytes)


def topk_cost(nq: int, n: int, k: int, elem: int = 4) -> tuple[float, float]:
    """One top-k call over scores [nq, n]: every score read once, k
    (value, index) pairs written a row."""
    return float(nq * n), float(nq * n * elem + nq * k * 8)


def visible_pairs(S: int, T: int, causal: bool = True, chunk: int = 0) -> int:
    """(query, key) pairs attention of S queries over T keys visits."""
    c = chunk or max(S, T)
    total = 0
    for start in range(0, S, c):
        rows = min(S, start + c) - start
        keys = min(T, start + c) - start
        if keys <= 0:
            continue
        if causal:
            full = min(rows, keys)
            total += full * (full + 1) // 2 + max(0, rows - keys) * keys
        else:
            total += rows * keys
    return total


def flash_cost(B: int, S: int, T: int, H: int, Hkv: int, D: int, elem: int,
               causal: bool = True, chunk: int = 0) -> tuple[float, float]:
    """One attention call: 4 x D operations a visible pair and head; q, k,
    v read once and the output written once."""
    pairs = visible_pairs(S, T, causal, chunk)
    nbytes = (2 * B * S * H * D + 2 * B * T * Hkv * D) * elem
    return 4.0 * B * H * D * pairs, float(nbytes)


def lm_layer_params(lm: dict) -> int:
    """Parameters of one dense decoder layer a token passes through."""
    d, nq, nkv, dh, f = (lm[k] for k in ("d_model", "n_q", "n_kv", "d_head",
                                         "d_ff"))
    return d * dh * (2 * nq + 2 * nkv) + 3 * d * f


def lm_sequence_flops(lm: dict, prompt: int, new_tokens: int) -> float:
    """Model flops of one sequence's greedy answer: a prefill of
    ``prompt`` tokens (the head on its last position alone) and
    ``new_tokens - 1`` decode steps, each step's head included; 2 a
    parameter a token passes through, plus causal attention (QK and PV,
    2 x d_head each a visible pair and query head)."""
    L, nq, dh = lm["n_layers"], lm["n_q"], lm["d_head"]
    head = 2.0 * lm["d_model"] * lm["vocab"]
    body = 2.0 * L * lm_layer_params(lm)
    attn = 4.0 * L * nq * dh
    flops = prompt * body + head + attn * prompt * (prompt + 1) / 2
    for t in range(new_tokens - 1):
        flops += body + head + attn * (prompt + t + 1)
    return flops
