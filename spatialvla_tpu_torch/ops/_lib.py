"""Build and load the port's CUDA kernels (``spatialvla_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at the
first kernel launch of a process, into ``spatialvla_tpu_torch/_build/``
(listed in ``.gitignore``), under a file name keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads at once.
A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
COMPILE_FLAGS = ("-c", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

DT_F32, DT_BF16 = 0, 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, x_dtype, qt, scale, out, out_dtype, M, N, K, gelu (the gate|up epilogue), stream
    "q8_matvec": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, x_dtype, norm_w, norm_dtype, eps, qt, scale, out, out_dtype, M, N, K, stream
    "q8_rmsnorm_matvec": (_P, _I, _P, _I, _F, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, x_dtype, qt, scale, G, work (q4_work_bytes), out, out_dtype, M, N, K, gelu, stream
    "q4_matvec": (_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, x_dtype, norm_w, norm_dtype, eps, qt, scale, G, work, out, out_dtype, M, N, K, stream
    "q4_rmsnorm_matvec": (_P, _I, _P, _I, _F, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P),
    # x, qt, M, N, K, G: the bytes of the work buffer the two above need (no launch)
    "q4_work_bytes": (_P, _P, _I, _I, _I, _I),
    # the FMA tiles at any M: x, x_dtype, norm_w (null: no norm), norm_dtype, eps, qt,
    # scale, G, out, out_dtype, M, N, K, stream
    "q4_tiled_fma": (_P, _I, _P, _I, _F, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    # x, qt, M, K, G: which kernel the two above launch (no stream, no launch)
    "q4_route": (_P, _P, _I, _I, _I),
    # h_in, upd, post_w, post_dtype, norm_w, norm_dtype, eps, qt, scale, h_out, out,
    # out_dtype, M, N, K, gelu, stream
    "q8_residual_rmsnorm_matvec": (_P, _P, _P, _I, _P, _I, _F, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P),
    # the same with qt packed int4 and G (0 per channel) after scale
    "q4_residual_rmsnorm_matvec": (_P, _P, _P, _I, _P, _I, _F, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                                   _I, _P),
    # qkv, cos, sin, ck, cv, position, attn, k_new, v_new, part, tickets, M, Nq, Nkv, D, S,
    # chunk, q_scale, cap, stream
    "decode_attention": (_P,) * 11 + (_I,) * 6 + (_F, _F, _P),
    # qkv, cos, sin, ck, cv, ks, vs, position, attn, k_new, v_new, part, tickets, M, Nq, Nkv,
    # D, S, chunk, q_scale, cap, stream
    "decode_attention_kv8": (_P,) * 13 + (_I,) * 6 + (_F, _F, _P),
    # h, upd, w, w_dtype, final_w, final_dtype, out, M, H (a multiple of 8 up to 8192),
    # eps, stream
    "norm_residual": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _F, _P),
    # gu, act, M, I, stream
    "gelu_mul": (_P, _P, _I, _I, _P),
    # q, k, v, prefix, valid, q_offset, out, lse, dtype, B, Tq, Tk, Nq, Nkv, D,
    # scale, cap, window, causal, stream
    "flash_fwd": (_P,) * 8 + (_I,) * 7 + (_F, _F, _I, _I, _P),
    # the FMA forward in either dtype (same arguments as flash_fwd)
    "flash_fwd_fma": (_P,) * 8 + (_I,) * 7 + (_F, _F, _I, _I, _P),
    # dtype, D: the route flash_fwd takes (0 "fma", 1 "mma", -1 refused; no launch)
    "flash_fwd_route": (_I, _I),
    # fma, dtype, B, Tq, Tk, Nq, Nkv, D, out int[10]: a forward call's launch
    # plan (no launch)
    "flash_fwd_plan": (_I,) * 8 + (_P,),
    # q, k, v, dout, lse, delta, prefix, valid, q_offset, dq, dtype, B, Tq, Tk,
    # Nq, Nkv, D, scale, cap, window, causal, stream
    "flash_bwd_dq": (_P,) * 10 + (_I,) * 7 + (_F, _F, _I, _I, _P),
    # ... dk, dv instead of dq
    "flash_bwd_dkv": (_P,) * 11 + (_I,) * 7 + (_F, _F, _I, _I, _P),
    # dtype, D: the route the two above take (0 "fma", 1 "mma", -1 refused; no launch)
    "flash_bwd_route": (_I, _I),
    # the FMA backward in either dtype: q, k, v, dout, lse, delta, prefix, valid,
    # q_offset, dq, dk, dv (dq or dk null: that kernel is not launched), dtype, B,
    # Tq, Tk, Nq, Nkv, D, scale, cap, window, causal, stream
    "flash_bwd_fma": (_P,) * 12 + (_I,) * 7 + (_F, _F, _I, _I, _P),
    # which (0 dq, 1 dk/dv), fma, dtype, B, Tq, Tk, Nq, Nkv, D, out int[7]: a
    # call's launch plan (no launch)
    "flash_bwd_plan": (_I,) * 9 + (_P,),
}


def sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from spatialvla_tpu_torch/csrc at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspatialvla_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path. One nvcc per source, all started together, then one
    link. The compiler's register/spill report goes to ``_build/<name>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        compiles = []
        for src in sources():
            if src.suffix != ".cu":
                continue
            obj = work / f"{src.stem}.o"
            compiles.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), obj))
        log, failed = [], []
        for src, proc, _ in compiles:
            out = proc.communicate()[0]
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out[-8000:]}")
        if not failed:
            tmp = work / path.name
            proc = subprocess.run([nvcc, *NVCC_FLAGS, *LINK_FLAGS, "-o", str(tmp),
                                   *(str(obj) for _, _, obj in compiles)],
                                  capture_output=True, text=True)
            log.append(f"== link\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-8000:]}")
        path.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed building {path.name}: " + "\n".join(failed))
        os.replace(tmp, path)  # atomic: concurrent builders never see a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` with ``args`` and the current stream; raises on a
    launch error (the entry returns cudaGetLastError())."""
    err = getattr(library(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


# Every kernel wrapper with the names of its launch counts (``counted``): a
# wrapper adds one to ``.launches`` where it launches its kernel, and the q4
# wrappers also count their tensor-core launches in ``.tiled_launches``. A
# CUDA graph that replays launches reads this list to know what it holds.
COUNTED: list = []


def counted(fn, *extra: str):
    """Register the kernel wrapper ``fn``: its ``launches`` and ``extra``
    counts, each set to 0. Returns fn."""
    names = ("launches",) + extra
    for a in names:
        setattr(fn, a, 0)
    COUNTED.append((fn, names))
    return fn


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return DT_F32
    if t.dtype == torch.bfloat16:
        return DT_BF16
    raise TypeError(f"kernel operand must be float32 or bfloat16, got {t.dtype}")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device and contiguous; a tensor on another
    kind of device raises (the wrappers use the plain version only for CPU
    tensors, the flash wrappers also for meta ones)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")
