#!/usr/bin/env python3
"""Where the time of one decode_attention launch goes, phase by phase, on an
NVIDIA GPU.

    python3 scripts/trace_decode_attention.py

Builds a copy of spatialvla_tpu_torch/csrc/decode.cu with a trace point
after each phase of decode_attention_kernel (thread 0 of each block writes
%globaltimer and clock64 to a device array), launches the bf16-cache kernel
once after a 64 MB write that leaves the L2 cold (as chip_smoke's timer
does), and prints, in ns from the first block's start, the median phase ends
of the blocks that hold valid slots and each merging block's row, plus the
SM clock the kernel ran at. Shapes: the serving path's M = 1, S = 278 and
M = 16, S = 332, and a one-chunk cache (M = 1, S = 32). The copy goes to
spatialvla_tpu_torch/_build/trace/ (gitignored); the kernel library is not
touched. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("start", "rope", "logits", "softmax", "p@V", "handoff", "end")
# (anchor in decode.cu, the text put in its place): trace point i after phase i
ANCHORS = (
    ("  const int pos = min(max(position[m], 0), S);\n",
     "  TRACE(0);\n  const int pos = min(max(position[m], 0), S);\n"),
    ("  if (c >= nlive) return;\n  __syncthreads();\n",
     "  if (c >= nlive) return;\n  __syncthreads();\n  TRACE(1);\n"),
    ("  __syncthreads();\n\n  // a warp per query head", "  __syncthreads();\n  TRACE(2);\n\n  // a warp per query head"),
    ("  __syncthreads();\n\n  // p @ V:", "  __syncthreads();\n  TRACE(3);\n\n  // p @ V:"),
    ("  // hand the partial over;", "  TRACE(4);\n  // hand the partial over;"),
    ("  const float* parts = ", "  TRACE(5);\n  const float* parts = "),
    ("__fmul_rn(ps, kvn[D + d])));\n      }\n    }\n  }\n",
     "__fmul_rn(ps, kvn[D + d])));\n      }\n    }\n  }\n  TRACE(6);\n"),
)
HEADER = r'''
__device__ unsigned long long g_trace[1 << 17];
#define TRACE(i) do { if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_trace[blockIdx.x * 16 + (i)] = t_; g_trace[blockIdx.x * 16 + 8 + (i)] = clock64(); } } while (0)
extern "C" int attention_trace(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, blocks * 16 * sizeof(unsigned long long));
}
'''


def build(lib_mod) -> ctypes.CDLL:
    src = (lib_mod.CSRC / "decode.cu").read_text()
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n' + HEADER, 1)
    for anchor, traced in ANCHORS:
        if src.count(anchor) != 1:
            raise SystemExit(f"trace anchor not found once in decode.cu: {anchor!r}")
        src = src.replace(anchor, traced)
    out = lib_mod.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_trace.cu").write_text(src)
    shutil.copy(lib_mod.CSRC / "common.cuh", out / "common.cuh")
    so = out / "libdecode_trace.so"
    subprocess.run([lib_mod._nvcc(), *lib_mod.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(out / "decode_trace.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.decode_attention.argtypes = lib_mod._SIGNATURES["decode_attention"]
    lib.decode_attention.restype = ctypes.c_int
    lib.attention_trace.argtypes = (ctypes.c_void_p, ctypes.c_int)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from spatialvla_tpu_torch.ops import _lib
    from spatialvla_tpu_torch.ops import decode_step as ds

    lib = build(_lib)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    g = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    Nq, Nkv, D = 8, 4, 256
    for M, S, pos in ((1, 278, [270]), (16, 332, list(range(300, 316))), (1, 32, [20])):
        def randn(*shape, std=1.0):
            return (torch.randn(shape, generator=g, device="cuda") * std).to(torch.bfloat16)

        qkv, ck, cv = randn(M, (Nq + 2 * Nkv) * D), randn(M, Nkv, S, D, std=0.3), randn(
            M, Nkv, S, D, std=0.3)
        position = torch.tensor(pos, dtype=torch.int32, device="cuda")
        cos, sin = ds.rope_tables(position + 1, D, 10000.0)
        out = torch.empty(M, Nq * D, dtype=torch.bfloat16, device="cuda")
        k_new = torch.empty(M, Nkv, D, dtype=torch.bfloat16, device="cuda")
        v_new = torch.empty_like(k_new)
        C = ds.attention_chunk(M, Nkv, S)
        scratch = ds.attention_scratch(M, Nkv, S, D, Nq, "cuda")
        n_tickets = -(-M * Nkv // 4) * 4
        for _ in range(3):  # the last launch is the one read back
            flush.zero_()
            err = lib.decode_attention(
                qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                position.data_ptr(), out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                scratch.data_ptr() + 4 * n_tickets, scratch.data_ptr(), M, Nq, Nkv, D, S, C,
                D ** -0.5, 50.0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"launch failed: cudaError {err}")
            torch.cuda.synchronize()
        blocks = M * Nkv * -(-S // C)
        buf = (ctypes.c_ulonglong * (blocks * 16))()
        if lib.attention_trace(ctypes.addressof(buf), blocks):
            raise SystemExit("cudaMemcpyFromSymbol failed")
        rows = [list(buf[b * 16:(b + 1) * 16]) for b in range(blocks)]
        live = [r for r in rows if r[1] > r[0]]
        t0 = min(r[0] for r in live)
        ghz = statistics.median((r[12] - r[8]) / (r[4] - r[0]) for r in live)
        med = [statistics.median(r[i] - t0 for r in live) for i in range(5)]
        print(f"M={M} S={S} C={C}: {blocks} blocks ({len(live)} with valid slots), SM clock "
              f"{ghz:.3f} GHz; median phase ends (ns): "
              + ", ".join(f"{p} {t:.0f}" for p, t in zip(PHASES, med)))
        for r in live:
            if r[6] > r[0]:
                print("  merging block: " + ", ".join(
                    f"{p} {r[i] - t0}" for i, p in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
