"""The arithmetic of the bf16 flash-attention kernel
(``csrc/flash_attention_sm90.cu``) against the JAX package on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
the plain version.  Here a torch emulation of its rounding, kept in this
file and off the main path, takes the same bf16 inputs as
``flash_attention_pallas`` (interpret mode) and ``flash_attention_ref``
and must agree with both at the bf16 contract of ``tests/test_kernels.py``
(atol 2e-2).  The emulation follows the kernel: 128-row q tiles and
128-row kv tiles, the kernel's tile skipping, q . k in fp32 from bf16
inputs, the scale applied to the fp32 scores after the product (folded
with log2(e) into one multiply before exp2), -1e30 for masked columns and
-inf past T with m starting at -1e30, P rounded to bf16 before P V while
the row sum adds the fp32 P, and out = O / max(l, 1e-20) rounded to bf16.
It also checks the kernel's test of which kv tiles need masking: a tile
that test lets through unmasked must hide no column from the 64 rows of a
consumer warpgroup."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jref
from repro_torch.kernels.flash_attention.ops import flash_attention
from test_torch_attention import _f32, _qkv

TOL = 2e-2
BQ = BKV = 128          # the kernel's q and kv tile rows
WG_ROWS = 64            # q rows of one consumer warpgroup
NEG = -1e30
LOG2E = 1.4426950408889634


def _kv_tiles(q0, S, T, causal, chunk):
    """The kernel's range of kv tiles for the q tile at row q0."""
    q_last = min(S, q0 + BQ) - 1
    lo, hi = 0, (T - 1) // BKV
    if causal:
        hi = min(hi, q_last // BKV)
    if chunk > 0 and (q_last // chunk) * chunk < T:
        lo = max(lo, (q0 // chunk) * chunk // BKV)
        hi = min(hi, ((q_last // chunk + 1) * chunk - 1) // BKV)
    return lo, hi


def _crosses(r0, k0, T, causal, chunk):
    """The kernel's test whether the kv tile at k0 needs masking for the
    warpgroup's rows [r0, r0 + 64): it crosses T, the diagonal or a chunk
    boundary."""
    if k0 + BKV > T or (causal and k0 + BKV - 1 > r0):
        return True
    if chunk > 0:
        c = r0 // chunk
        return not ((r0 + WG_ROWS - 1) // chunk == c and k0 // chunk == c
                    and (k0 + BKV - 1) // chunk == c)
    return False


def sm90_emulation(q, k, v, *, causal=True, chunk=0):
    """q [B, S, H, D], k/v [B, T, Hkv, D] bf16 -> [B, S, H, D] bf16, rounded
    where the kernel rounds."""
    B, S, H, D = q.shape
    T, G = k.shape[1], H // k.shape[2]
    f32 = torch.float32
    scale = torch.tensor(D ** -0.5, dtype=f32) * torch.tensor(LOG2E,
                                                              dtype=f32)
    qf = q.to(f32).transpose(1, 2)                       # [B, H, S, D]
    pad = (0, 0, 0, 0, 0, BKV)          # TMA reads zeros past T
    kf = torch.nn.functional.pad(k.to(f32), pad).transpose(1, 2)
    vf = torch.nn.functional.pad(v.to(f32), pad).transpose(1, 2)
    kf, vf = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    rows = torch.arange(S)
    lo = (rows // chunk) * chunk if chunk else torch.zeros_like(rows)
    hi = rows + 1 if causal else torch.full_like(rows, T)
    if chunk:
        hi = torch.minimum(hi, lo + chunk)
    out = torch.empty(B, H, S, D, dtype=f32)
    for q0 in range(0, S, BQ):
        r = rows[q0:q0 + BQ]
        kt_lo, kt_hi = _kv_tiles(q0, S, T, causal, chunk)
        m = torch.full((B, H, len(r)), NEG, dtype=f32)
        l = torch.zeros((B, H, len(r)), dtype=f32)
        o = torch.zeros((B, H, len(r), D), dtype=f32)
        for kt in range(kt_lo, kt_hi + 1):
            k0 = kt * BKV
            cols = torch.arange(k0, k0 + BKV)
            x = (qf[:, :, r] @ kf[:, :, k0:k0 + BKV].transpose(-1, -2)) * scale
            ok = (cols >= lo[r, None]) & (cols < hi[r, None])
            for r0 in (q0, q0 + WG_ROWS):
                part = (r >= r0) & (r < r0 + WG_ROWS)
                if part.any() and not _crosses(r0, k0, T, causal, chunk):
                    assert bool(ok[part].all()) and k0 + BKV <= T, (r0, k0)
            x = torch.where(cols < T, torch.where(ok, x, NEG), -torch.inf)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + \
                p.to(torch.bfloat16).to(f32) @ vf[:, :, k0:k0 + BKV]
            m = mx
        out[:, :, r] = o / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


def _check(B, S, T, H, HKV, D, causal, chunk, *, pallas=None):
    """The emulation against the JAX reference (and, given (bq, bkv), the
    Pallas kernel in interpret mode) and the port's CPU path, all on the
    same bf16 inputs."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(S * 7 + T + H + chunk, B, S, T, H, HKV,
                                      D, "bfloat16")
    got = sm90_emulation(tq, tk, tv, causal=causal, chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(
        _f32(got), _f32(jref(jq, jk, jv, causal=causal, chunk=chunk)),
        atol=TOL)
    np.testing.assert_allclose(
        _f32(got), _f32(flash_attention(tq, tk, tv, causal=causal,
                                        chunk=chunk)), atol=TOL)
    if pallas is not None:
        bq, bkv = pallas
        want = flash_attention_pallas(jq, jk, jv, causal=causal, chunk=chunk,
                                      bq=bq, bkv=bkv, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL)


@pytest.mark.parametrize("B,S,H,HKV,D,bq,bkv",
                         [(1, 128, 2, 2, 64, 64, 64),     # MHA
                          (2, 256, 4, 2, 64, 128, 64),    # GQA
                          (1, 256, 8, 1, 128, 64, 128)])  # MQA
def test_sm90_emulation_matches_pallas_sweep(B, S, H, HKV, D, bq, bkv):
    _check(B, S, S, H, HKV, D, True, 0, pallas=(bq, bkv))


@pytest.mark.parametrize("chunk", [32, 48, 128])
def test_sm90_emulation_matches_pallas_chunked(chunk):
    _check(1, 256, 256, 4, 2, 64, True, chunk, pallas=(64, 64))


@pytest.mark.parametrize("B,S,T,H,HKV,D,causal,chunk", [
    (2, 1, 1, 12, 2, 128, True, 0),        # one query row
    (2, 1, 70, 4, 2, 64, False, 0),
    (3, 100, 100, 12, 2, 128, True, 0),
    (2, 70, 131, 4, 2, 64, False, 0),
    (2, 200, 200, 4, 2, 64, True, 48),
    (1, 129, 129, 2, 1, 128, True, 0),     # ragged against 128-row tiles
    (1, 1000, 1000, 4, 2, 64, True, 0),
    (1, 1023, 1023, 2, 1, 128, True, 0),
    (1, 300, 260, 2, 1, 64, False, 96),
    # rows whose chunk starts at or past T see no key: all T averaged
    (2, 100, 70, 4, 2, 64, True, 32),
    (2, 130, 70, 4, 2, 128, False, 48)])
def test_sm90_emulation_matches_reference_ragged(B, S, T, H, HKV, D, causal,
                                                 chunk):
    _check(B, S, T, H, HKV, D, causal, chunk)


def test_sm90_emulation_matches_pallas_g1_head():
    """One batch row of G1's prefill: S = T = 1024, 12 q heads over 2 kv
    heads of 128."""
    _check(1, 1024, 1024, 12, 2, 128, True, 0, pallas=(512, 512))


def test_ptxas_report_reads_registers_and_spills():
    """``chip_smoke.py`` asserts 0 spill bytes for the kernel's
    instantiations from the ``-Xptxas -v`` log; the parser must read each
    entry's own lines."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    mangled = ("_ZN56_GLOBAL__N__2ba04ffe_23_flash_attention_sm90_cu_3cad69c2"
               "27flash_attention_kernel_sm90ILi{}EEEv14CUtensorMap_stS1_S1_"
               "P13__nv_bfloat16iiiiiiif")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled.format(128)}' "
        f"for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled.format(128)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format(64)}' "
        f"for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled.format(64)}",
        "    32 bytes stack frame, 36 bytes spill stores, 48 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers"])
    rep = chip_smoke.ptxas_report(log)
    assert len(rep) == 2
    by_d = {128 if "128" in name else 64: r for name, r in rep.items()}
    assert by_d[128] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                         "registers": 168}
    assert by_d[64] == {"stack": 32, "spill_stores": 36, "spill_loads": 48,
                        "registers": 40}
    assert all("flash_attention_kernel_sm90" in name for name in rep)
