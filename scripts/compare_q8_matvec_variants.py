#!/usr/bin/env python3
"""Time patched copies of csrc/q8_matvec.cu beside the kernel itself, on an
NVIDIA GPU, to see where the per-channel int4 instance spends its time.

    python3 scripts/compare_q8_matvec_variants.py

Each variant is the source with a few lines replaced (VARIANTS), built with
nvcc into its own library under ``_build/variants/`` (with q4_matvec.cu, so
that the q4 wrappers reach it) and loaded in place of the port's library
while it is timed. Some variants are diagnostics that compute a wrong
result on purpose: "loads only" streams the weights but does one XOR a
unit instead of the FMAs, "no weight stream" skips the weight loop (launch,
prologue, staging, reduction and stores remain). The shapes are the int4
decode shapes at M = 1 (and two at M = 16), timed with chip_smoke's
CUDA-graph timer, each variant in turn and the kernel first and last. The
variants change only the int4 instances. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "spatialvla_tpu_torch" / "csrc"
OUT = ROOT / "spatialvla_tpu_torch" / "_build" / "variants"
VARIANTS = {  # name: [(text in q8_matvec.cu, its replacement)]
    "kernel": [],
    "two-pass norm": [("const bool fused = kNorm && kInt4 && MR == 1 && cu == U && K <= 4 * kThreads * kP;",
                       "const bool fused = false;")],
    "3 blocks an SM at MR <= 2": [("__global__ void __launch_bounds__(kThreads, 2)\nqmatvec_kernel",
                                   "__global__ void __launch_bounds__(kThreads, (kInt4 && MR <= 2) ? 3 : 2)\n"
                                   "qmatvec_kernel")],
    "loads only": [("      fma_unit<MR, kInt4>(acc, w, xs, xstride, u, cu);",
                    "      if (kInt4) acc[0][0] += __int_as_float((w[0].x ^ w[1].y ^ w[2].z ^ w[3].w) & 0x3F800000);\n"
                    "      else fma_unit<MR, kInt4>(acc, w, xs, xstride, u, cu);")],
    "no weight stream": [("    for (int u = u0; u < cn; u += step) {",
                          "    for (int u = u0; u < (kInt4 ? 0 : cn); u += step) {")],
}
SHAPES = (  # name, M, K, N, x dtype
    ("q4_rmsnorm_matvec", 1, 2304, 18432, "float32"), ("q4_rmsnorm_matvec", 1, 2304, 4096, "float32"),
    ("q4_matvec", 1, 2304, 18432, "bfloat16"), ("q4_matvec", 1, 2304, 8194, "bfloat16"),
    ("q4_matvec", 1, 9216, 2304, "bfloat16"), ("q4_matvec", 1, 2048, 2304, "bfloat16"),
    ("q4_rmsnorm_matvec", 16, 2304, 18432, "float32"), ("q4_matvec", 16, 9216, 2304, "bfloat16"),
)


def build_all(nvcc, nvcc_flags):
    """One library a variant, every nvcc started together."""
    source = (CSRC / "q8_matvec.cu").read_text()
    jobs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: the patched text is not in q8_matvec.cu once")
            text = text.replace(old, new)
        (d / "q8_matvec.cu").write_text(text)
        for f in ("q4_matvec.cu", "common.cuh"):
            shutil.copy(CSRC / f, d)
        jobs[name] = (d, [subprocess.Popen([nvcc, *nvcc_flags, "-c", "-o", str(d / f"{s}.o"),
                                             str(d / f"{s}.cu")], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)
                          for s in ("q8_matvec", "q4_matvec")])
    libs = {}
    for name, (d, procs) in jobs.items():
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise SystemExit(f"variant {name!r} failed to build:\n" + "\n".join(logs)[-4000:])
        subprocess.run([nvcc, *nvcc_flags, "-shared", "-o", str(d / "lib.so"), str(d / "q8_matvec.o"),
                        str(d / "q4_matvec.o")], check=True)
        libs[name] = d / "lib.so"
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from spatialvla_tpu_torch.ops import _lib, quant

    card = chip_smoke.card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    loaded = {}
    for name, path in build_all(_lib._nvcc(), _lib.NVCC_FLAGS).items():
        lib = ctypes.CDLL(str(path))
        for fn in ("q4_matvec", "q4_rmsnorm_matvec"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    timer = chip_smoke.Timer(torch)
    order = list(VARIANTS) + ["kernel"]
    for name, M, K, N, x_dtype in SHAPES:
        x, nw = randn(M, K, dtype=getattr(torch, x_dtype)), randn(K, std=0.1)
        w = quant.quantize_int4(randn(K, N, dtype=torch.float32, std=0.02))
        args = (x, nw, w["qt"], w["scale"]) if "rmsnorm" in name else (x, w["qt"], w["scale"])
        kern, plain = getattr(quant, name), getattr(quant, name + "_plain")
        ref = plain(*args)
        row = []
        for v in order:
            _lib.library = lambda lib=loaded[v]: lib  # the wrappers look it up at each launch
            _, r = chip_smoke.rel_err(kern(*args), ref)
            row.append(f"{v} {timer(lambda: kern(*args)):.4f} ms (rel {r:.1e})")
        print(f"{name} M={M} {K}->{N} ({x_dtype} x): " + " | ".join(row), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
