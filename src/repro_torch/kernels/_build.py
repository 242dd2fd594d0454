"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, into ``build/repro_torch/<hash of the sources>/`` under the
repository root (listed in ``.gitignore``), so a changed source rebuilds
and an unchanged one is loaded as it is.  A missing ``nvcc`` or a failed
compile raises with the compiler's output: there is no fallback.

Each C function returns ``cudaGetLastError()`` after its launch; the
wrappers raise through :func:`check` when that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
#: no --use_fast_math (the models' log1p/log2/divisions must stay within
#: rtol 2e-5 of the reference), and no FMA contraction, so each operation
#: rounds like the plain version's
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
#: C signature of every exported function: (argtypes), all return int
SIGNATURES = {
    # scores, nq, n, row_stride, k, n_seg, seg_len, cand_vals, cand_idxs,
    # vals, idxs, stream
    "repro_topk_f32": (_P, _I64, _I64, _I64, _I32, _I32, _I64, _P, _P, _P,
                       _P, _P),
    # tf, dl, df, cf, n, group, model_code, n_models, n_docs, avg_dl,
    # total_terms, avg_len, out, stream
    "repro_fused_scoring": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _F32,
                            _F32, _F32, _F32, _P, _P),
    # emb, emb_qstride, q, base, nq, n, dim, k, group, n_seg, seg_len,
    # tile, cand_vals, cand_idxs, vals, idxs, stream
    "repro_dense_topk": (_P, _I64, _P, _P, _I64, _I64, _I32, _I32, _I32,
                         _I32, _I64, _I64, _P, _P, _P, _P, _P),
    # codes, table, table's query and subspace strides, base, nq, n, m,
    # n_codes, k, cluster, seg_len, tile, vals, idxs, stream
    "repro_pq_topk": (_P, _P, _I64, _I64, _P, _I64, _I64, _I32, _I32, _I32,
                      _I32, _I64, _I64, _P, _P, _P),
    # q, k, v, out, B, S, T, H, Hkv, D, causal, chunk, is_bf16, scale,
    # stream
    "repro_flash_attention": (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                              _I32, _I32, _I32, _I32, _F32, _P),
    # D -> dynamic shared memory bytes of the bf16 (sm90) flash kernel
    "repro_flash_attention_sm90_smem": (_I32,),
    # blocks_x, blocks_y, threads, cluster, stream: an empty launch
    "repro_empty_launch": (_I32, _I32, _I32, _I32, _P),
    # the device launch counters (csrc/launch_count.cuh): count, reset
    **{f"repro_launches_{name}": (_P, _I32) for name in (
        "topk", "fused_scoring", "dense_topk", "pq_topk", "flash_attention",
        "flash_attention_sm90")},
}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the compiler commands in parallel; raise with the output of the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], None
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (cmd, p.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(
            f"CUDA kernel build failed (exit {rc}): {' '.join(cmd)}\n{out}")
    return logs


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists;
    returns the shared library's path.  The log (ptxas register and
    shared-memory report included) is kept beside it as ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "librepro_kernels.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    objs = [out_dir / (src.stem + ".o") for src in sources()]
    compile_cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                     "-o", str(obj)] for src, obj in zip(sources(), objs)]
    logs = _run_all(compile_cmds)
    tmp = out_dir / f"librepro_kernels.{os.getpid()}.so"
    logs += _run_all([[nvcc, ARCH, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
    (out_dir / "build.log").write_text("\n".join(logs))
    tmp.replace(lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with ``argtypes``
    and ``restype`` declared for every function — an undeclared pointer
    would be cut to 32 bits."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    path = build().parent / "build.log"
    return path.read_text() if path.exists() else ""


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
