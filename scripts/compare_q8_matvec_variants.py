#!/usr/bin/env python3
"""Time patched copies of csrc/q8_matvec.cu beside the kernel itself, on an
NVIDIA GPU, to see where the int4 instances spend their time.

    python3 scripts/compare_q8_matvec_variants.py [--against FILE] [variant ...]

Each variant (all of VARIANTS, or those named) is the source with a few
lines replaced (with --against, also FILE, another q8_matvec.cu such as a
parent commit's, in its place), built with nvcc into its own library under
``_build/variants/`` (linked with q4_matvec.cu, so that the q4 wrappers
reach it) and loaded in place of the port's library while it is timed; its
qmatvec_kernel instances' registers and spills are printed first. Some
variants are diagnostics that compute a wrong result on purpose: "loads
only" streams the weights (and the grouped scales) but does one XOR a unit
instead of the FMAs, "no weight stream" skips the weight loop (launch,
prologue, staging, reduction and stores remain). "codes scaled from MR=R"
moves the grouped instance's switch between scaling each half unit's sums
and scaling its codes; "two blocks an SM, grouped" and "one block an SM,
grouped MR>=4" move its register bound (one block an SM from 8 rows on).
A variant runs at the shapes of its formats: per-channel int4 decode
shapes at M = 1 (and two at M = 16), and 128-column-grouped gate|up and
down at every rows instance (M = 1, 2, 4, 8, 16) plus the other grouped
decode shapes at M = 1; each timed with chip_smoke's CUDA-graph timer,
each variant in turn and the kernel first and last. The variants change
only the int4 instances. Needs CUDA and nvcc.
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
PC, G128 = "per channel", "g128"
AGAINST = "against"  # the --against source
SCALE_SWITCH = "constexpr int kScaleCodesFromRows = 8;"
BLOCKS = "kGrouped && MR >= 8 ? 1 : 2"  # qmatvec_kernel's blocks an SM (__launch_bounds__)
FMA_CALL = "        fma_half<MR, kInt4, kScale>(acc, w, s[kScale == 1 ? h : 0], xs, xstride, u + h * cu, h);"
VARIANTS = {  # name: ([(text in q8_matvec.cu, its replacement)], formats it is timed at)
    "kernel": ([], (PC, G128)),
    "two-pass norm": ([("const bool fused = kNorm && (kInt4 || kResid) && MR == 1 && cu == U && K <= 4 * kThreads * kP;",
                        "const bool fused = false;")], (PC,)),
    "3 blocks an SM at MR <= 2": ([(BLOCKS, "kGrouped && MR >= 8 ? 1 : (kInt4 && MR <= 2) ? 3 : 2")], (PC,)),
    "loads only": ([(FMA_CALL, "        if (kInt4) acc[0][0] += __int_as_float((w[0].x ^ w[1].y ^ w[2].z ^ "
                                "w[3].w ^ __float_as_int(s[0][h])) & 0x3F800000);\n"
                                "        else " + FMA_CALL.lstrip())], (PC, G128)),
    "no weight stream": ([("    for (int u = u0; u < cn; u += step) {",
                           "    for (int u = u0; u < (kInt4 ? 0 : cn); u += step) {")], (PC,)),
    "two blocks an SM, grouped": ([(BLOCKS, "2")], (G128,)),
    "one block an SM, grouped MR>=4": ([(BLOCKS, "kGrouped && MR >= 4 ? 1 : 2")], (G128,)),
    **{f"codes scaled from MR={r}": ([(SCALE_SWITCH, SCALE_SWITCH.replace("8", str(r)))], (G128,))
       for r in (1, 2, 4, 16)},
}
SHAPES = (  # format, name, M, K, N, x dtype
    (PC, "q4_rmsnorm_matvec", 1, 2304, 18432, "float32"), (PC, "q4_rmsnorm_matvec", 1, 2304, 4096, "float32"),
    (PC, "q4_matvec", 1, 2304, 18432, "bfloat16"), (PC, "q4_matvec", 1, 2304, 8194, "bfloat16"),
    (PC, "q4_matvec", 1, 9216, 2304, "bfloat16"), (PC, "q4_matvec", 1, 2048, 2304, "bfloat16"),
    (PC, "q4_rmsnorm_matvec", 16, 2304, 18432, "float32"), (PC, "q4_matvec", 16, 9216, 2304, "bfloat16"),
) + tuple((G128, "q4_rmsnorm_matvec", M, 2304, 18432, "float32") for M in (1, 2, 4, 8, 16)) + tuple(
    (G128, "q4_matvec", M, 9216, 2304, "bfloat16") for M in (1, 2, 4, 8, 16)) + (
    (G128, "q4_rmsnorm_matvec", 1, 2304, 4096, "float32"), (G128, "q4_matvec", 1, 2304, 8194, "bfloat16"),
    (G128, "q4_matvec", 1, 2048, 2304, "bfloat16"),
)


def build_all(nvcc, nvcc_flags, names, against=None):
    """One library a variant, every nvcc started together; q4_matvec.cu is
    compiled once and linked into each. Returns {name: (library, nvcc's
    report)}."""
    source = (CSRC / "q8_matvec.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    (OUT / "q4").mkdir(parents=True)
    for f in ("q4_matvec.cu", "common.cuh"):
        shutil.copy(CSRC / f, OUT / "q4")

    def nvcc_c(d, stem):
        return subprocess.Popen([nvcc, *nvcc_flags, "-c", "-Xptxas", "-v", "-o", str(d / f"{stem}.o"),
                                 str(d / f"{stem}.cu")], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    q4 = nvcc_c(OUT / "q4", "q4_matvec")
    jobs = {}
    for i, name in enumerate(names):
        d = OUT / f"v{i}"
        d.mkdir()
        text = Path(against).read_text() if name == AGAINST else source
        for old, new in VARIANTS.get(name, ([],))[0]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: the patched text is not in q8_matvec.cu once")
            text = text.replace(old, new)
        (d / "q8_matvec.cu").write_text(text)
        shutil.copy(CSRC / "common.cuh", d)
        jobs[name] = (d, nvcc_c(d, "q8_matvec"))
    if q4.wait():
        raise SystemExit("q4_matvec.cu failed to build:\n" + q4.communicate()[0][-4000:])
    libs = {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n" + log[-4000:])
        subprocess.run([nvcc, *nvcc_flags, "-shared", "-o", str(d / "lib.so"), str(d / "q8_matvec.o"),
                        str(OUT / "q4" / "q4_matvec.o")], check=True)
        (d / "lib.log").write_text(log)
        libs[name] = (d / "lib.so", d / "lib.log")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from bench_q8_matvec import register_report
    from spatialvla_tpu_torch.ops import _lib, quant

    args = sys.argv[1:]
    against = None
    if args[:1] == ["--against"]:
        against, args = args[1], args[2:]
    names = ["kernel"] + [n for n in (args or VARIANTS) if n != "kernel"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"no variant {unknown}; the variants: {list(VARIANTS)}")
    if against:
        names.insert(1, AGAINST)
    card = chip_smoke.card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    loaded = {}
    for name, (path, log) in build_all(_lib._nvcc(), _lib.NVCC_FLAGS, names, against).items():
        lib = ctypes.CDLL(str(path))
        for fn in ("q4_matvec", "q4_rmsnorm_matvec"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
        regs = [f"{inst} {r}" + (f" (spills {st}/{ld} B)" if st or ld else "")
                for inst, r, st, ld in register_report(log) if inst.startswith("int4")]
        print(f"registers, {name}: " + ", ".join(regs), flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    timer = chip_smoke.Timer(torch)
    for fmt, name, M, K, N, x_dtype in SHAPES:
        order = [v for v in names if v == AGAINST or fmt in VARIANTS[v][1]] + ["kernel"]
        if len(order) == 2:
            continue  # no variant of this format was asked for
        x, nw = randn(M, K, dtype=getattr(torch, x_dtype)), randn(K, std=0.1)
        w = quant.quantize_int4(randn(K, N, dtype=torch.float32, std=0.02),
                                128 if fmt == G128 else None)
        args = (x, nw, w["qt"], w["scale"]) if "rmsnorm" in name else (x, w["qt"], w["scale"])
        kern, plain = getattr(quant, name), getattr(quant, name + "_plain")
        ref = plain(*args)
        row = []
        for v in order:
            _lib.library = lambda lib=loaded[v]: lib  # the wrappers look it up at each launch
            _, r = chip_smoke.rel_err(kern(*args), ref)
            row.append(f"{v} {timer(lambda: kern(*args)):.4f} ms (rel {r:.1e})")
        print(f"{name} {fmt} M={M} {K}->{N} ({x_dtype} x): " + " | ".join(row), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
