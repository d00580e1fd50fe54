#!/usr/bin/env python3
"""Time and check the int8 matvec kernels (q8_matvec, q8_rmsnorm_matvec) on
an NVIDIA GPU: the short loop for working on csrc/q8_matvec.cu.

    python3 scripts/bench_q8_matvec.py

Builds the kernel library, prints each q8_matvec_kernel instance's
registers and spills from nvcc's report (``_build/*.log``), checks every
rows instance (M = 1..16) and a ragged N against the plain versions, checks
that two launches give identical bits, then times the q8 shapes of
chip_smoke.kernel_phases (the head, o, down, qkv and gate|up; M = 1 and 16)
and the o projection at M = 1, 2 and 16 with chip_smoke's CUDA-graph timer
(L2 flushed before each run): the kernel, its plain version and
torch._weight_int8pack_mm (for the RMSNorm variant on the normed x, the
matmul alone). Max relative error to plain must stay below 1e-2. Needs CUDA
and nvcc.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOL = 1e-2
# (name, M, K, N): chip_smoke's q8 shapes, then the o projection at M = 1, 2, 16
SHAPES = (
    ("q8_matvec", 1, 2304, 8194), ("q8_matvec", 16, 9216, 2304), ("q8_matvec", 1, 2048, 2304),
    ("q8_matvec", 1, 9216, 2304), ("q8_matvec", 2, 2048, 2304), ("q8_matvec", 16, 2048, 2304),
    ("q8_rmsnorm_matvec", 1, 2304, 4096), ("q8_rmsnorm_matvec", 1, 2304, 18432),
    ("q8_rmsnorm_matvec", 16, 2304, 4096), ("q8_rmsnorm_matvec", 16, 2304, 18432),
)


def register_report(log: Path) -> list:
    """(instance, registers, spill stores, spill loads) of each
    q8_matvec_kernel<MR, kNorm> in nvcc's -Xptxas -v output."""
    rows, current = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"q8_matvec_kernelILi(\d+)ELb([01])E", m.group(1))
            current = f"MR={k.group(1)} norm={k.group(2)}" if k else None
            spills = None
            continue
        if current is None:
            continue
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if s:
            spills = (int(s.group(1)), int(s.group(2)))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            rows.append((current, int(r.group(1))) + (spills or (None, None)))
            current = None
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from spatialvla_tpu_torch.ops import _lib, quant

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    lib = _lib.build()
    _lib.library()
    for inst, regs, st, ld in register_report(lib.with_suffix(".log")):
        print(f"q8_matvec_kernel {inst}: {regs} registers, spill stores {st} B, loads {ld} B")

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    def qweight(N, K):
        return quant.quantize_int8(randn(K, N, dtype=torch.float32, std=0.02))

    # every rows instance and its edges, ragged N, chunked K, both x types
    worst = 0.0
    for M in range(1, 17):
        for K, N in ((2304, 40), (9216, 100), (2320, 4100)):
            w = qweight(N, K)
            for x_dtype in (torch.float32, torch.bfloat16):
                x, nw = randn(M, K, dtype=x_dtype), randn(K, std=0.1)
                r1 = chip_smoke.rel_err(quant.q8_matvec(x, w["qt"], w["scale"]),
                                        quant.q8_matvec_plain(x, w["qt"], w["scale"]))[1]
                r2 = chip_smoke.rel_err(quant.q8_rmsnorm_matvec(x, nw, w["qt"], w["scale"]),
                                        quant.q8_rmsnorm_matvec_plain(x, nw, w["qt"],
                                                                      w["scale"]))[1]
                worst = max(worst, r1, r2)
                if not (r1 < TOL and r2 < TOL):
                    print(f"FAIL M={M} K={K} N={N} x {x_dtype}: rel {r1:.3e} / {r2:.3e}")
                    return 1
    print(f"check: M=1..16 x (K, N) in (2304, 40), (9216, 100), (2320, 4100) x fp32/bf16 x: "
          f"max rel {worst:.3e} (bound {TOL})", flush=True)
    x, w = randn(16, 9216, dtype=torch.float32), qweight(2304, 9216)
    a = quant.q8_matvec(x, w["qt"], w["scale"])
    b = quant.q8_matvec(x, w["qt"], w["scale"])
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        print("FAIL: two launches differ")
        return 1

    timer = chip_smoke.Timer(torch)
    for name, M, K, N in SHAPES:
        norm = name == "q8_rmsnorm_matvec"
        x, nw, w = randn(M, K, dtype=torch.float32 if norm else torch.bfloat16), randn(K, std=0.1), \
            qweight(N, K)
        args = (x, nw, w["qt"], w["scale"]) if norm else (x, w["qt"], w["scale"])
        kern = getattr(quant, name)
        plain = getattr(quant, name + "_plain")
        d, r = chip_smoke.rel_err(kern(*args), plain(*args))
        ms, pms = timer(lambda: kern(*args)), timer(lambda: plain(*args))
        xl = quant._rms_bf16(x, nw, 1e-6) if norm else x
        lib, _ = chip_smoke.library_int8pack(torch, timer, xl, w["qt"], w["scale"])
        nbytes = chip_smoke.nbytes_of(*args) + M * N * 2
        bound, by = chip_smoke.bound(nbytes, 2 * M * N * K)
        print(f"{name} M={M} {K}->{N}: kernel {ms:.4f} ms plain {pms:.4f} ms library "
              f"{'(matmul alone) ' if norm else ''}{lib} ms bound {bound:.4f} ms ({by}) "
              f"rel err {r:.3e}", flush=True)
        if not r < TOL:
            print(f"FAIL {name} M={M}: rel err {r}")
            return 1
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
