#!/usr/bin/env python3
"""Check and time the many-row int4 kernels of csrc/q4_matvec.cu on an
NVIDIA GPU: the bf16 tensor-core kernel that q4_matvec / q4_rmsnorm_matvec
take above 16 rows (route "tiled"), beside the fp32 FMA tiles it replaced
there (q4_tiled_fma). The short loop for working on that kernel.

    python3 scripts/bench_q4_tile.py [--check] [variant ...]

Builds the kernel library and prints the registers and spills of each
q4_mma_kernel<MF, NF, WN, grouped, align>, q4_stage_x and q4_tile_kernel
instance from nvcc's report (``_build/*.log``). Checks every shape below,
per channel and in 128- and 16-column groups where they tile K, against the
plain versions (fp32 out within chip_smoke.Q4_FP32_TOL, bf16 out within
2e-2), its route, and two launches for identical bits. Then (unless
--check) times each shape with chip_smoke's CUDA-graph timer (L2 flushed
before each run): the kernel, the FMA tiles, the plain version,
torch._weight_int4pack_mm (for the RMSNorm variants on the normed x, the
matmul alone) and the bound; and the dequantize + matmul path that qmatmul
takes above 512 rows (quant.dequant_matmul) at M = 256, 277, 512 and 577
(ZoeDepth's tokens) beside the kernel, for the crossover.

A variant is a patched copy of q4_matvec.cu (VARIANTS: another tile or
warp shape, a register bound for the grouped instances, the K split off or
deeper, or the x' staging pass alone), built
into ``_build/variants_q4/`` and
timed at every shape beside the kernel (the kernel first and last). Needs
CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "spatialvla_tpu_torch" / "csrc"
OUT = ROOT / "spatialvla_tpu_torch" / "_build" / "variants_q4"
BF16_TOL = 2e-2
# (tag, wrapper, M, K, N, formats): the int4 prefill's projections at 277
# rows (Gemma2-2B), SigLIP-so400m's and the projector's at 256 rows (per
# channel, as quantize_vision_params makes them), qkv at 512 and 17 rows
LM, VISION = ("pc", "g128"), ("pc",)
SHAPES = (
    ("qkv", "q4_rmsnorm_matvec", 277, 2304, 4096, LM),
    ("gate|up", "q4_rmsnorm_matvec", 277, 2304, 18432, LM),
    ("o", "q4_matvec", 277, 2048, 2304, LM),
    ("down", "q4_matvec", 277, 9216, 2304, LM),
    ("siglip q/k/v/o", "q4_matvec", 256, 1152, 1152, VISION),
    ("siglip fc1", "q4_matvec", 256, 1152, 4304, VISION),
    ("siglip fc2", "q4_matvec", 256, 4304, 1152, VISION),
    ("projector", "q4_matvec", 256, 1152, 2304, VISION),
    ("qkv", "q4_rmsnorm_matvec", 512, 2304, 4096, LM),
    ("qkv", "q4_rmsnorm_matvec", 17, 2304, 4096, LM),
)
GROUP = {"pc": None, "g128": 128, "g16": 16}
TILES = "constexpr int kMF = 2, kNF = 4, kWN = 4;"
LAUNCH = "  launch_mma_tile<kMF, kNF, kWN, kGrouped>("
BOUNDS = "__global__ void __launch_bounds__(32 * WN)\nq4_mma_kernel"
WANT = "  const int want = blocks >= 2 * sm_count() ? 1 : (4 * sm_count() + blocks - 1) / blocks;"
VARIANTS = {  # name: [(text in q4_matvec.cu, its replacement)]
    "tiles 64x128": [(TILES, "constexpr int kMF = 4, kNF = 4, kWN = 4;")],
    "2 warps of 32x64": [(TILES, "constexpr int kMF = 2, kNF = 8, kWN = 2;")],
    "grouped 3 blocks an SM": [(BOUNDS,
                                BOUNDS.replace("(32 * WN)", "(32 * WN, kGrouped ? 3 : 1)"))],
    "no K split": [(WANT, "  const int want = 1;")],
    "K split below 4 blocks an SM": [(WANT, WANT.replace("blocks >= 2 * sm_count() ? 1 : ", ""))],
    "staging only": [(LAUNCH,
                      "  if (M > 0) return static_cast<int>(cudaGetLastError());\n" + LAUNCH)],
}
CROSSOVER = ((2304, 4096), (2304, 18432))  # (K, N) of qkv and gate|up
CROSSOVER_M = (256, 277, 512, 577)


def register_report(log: Path) -> list:
    """(instance, registers, spill stores, spill loads) of the many-row int4
    kernels in nvcc's -Xptxas -v output."""
    rows, current = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"q4_mma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])ELi(\d+)E", name)
            s = re.search(r"q4_stage_xILb([01])E", name)
            f = re.search(r"q4_tile_kernelILb([01])ELi(\d)E", name)
            current = (f"q4_mma_kernel {16 * int(k[1])}x{8 * int(k[2]) * int(k[3])} "
                       f"{'grouped' if k[4] == '1' else 'per channel'} align {k[5]}" if k else
                       f"q4_stage_x norm={s[1]}" if s else
                       f"q4_tile_kernel norm={f[1]} groups={f[2]}" if f else None)
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


def build_variants(names):
    """One library a variant of q4_matvec.cu, every nvcc started together,
    linked with q8_matvec.cu (compiled once). Returns {name: (library,
    nvcc's report)}."""
    from spatialvla_tpu_torch.ops import _lib

    nvcc, flags = _lib._nvcc(), list(_lib.NVCC_FLAGS)
    source = (CSRC / "q4_matvec.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    (OUT / "q8").mkdir(parents=True)

    def compile_(d, stem):
        for f in ("common.cuh",) + (("q8_matvec.cu",) if stem == "q8_matvec" else ()):
            shutil.copy(CSRC / f, d)
        return subprocess.Popen([nvcc, *flags, "-c", "-Xptxas", "-v", "-o", str(d / f"{stem}.o"),
                                 str(d / f"{stem}.cu")], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    q8 = compile_(OUT / "q8", "q8_matvec")
    jobs = {}
    for i, name in enumerate(names):
        d = OUT / f"v{i}"
        d.mkdir()
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: the patched text is not in q4_matvec.cu once")
            text = text.replace(old, new)
        (d / "q4_matvec.cu").write_text(text)
        jobs[name] = (d, compile_(d, "q4_matvec"))
    if q8.wait():
        raise SystemExit("q8_matvec.cu failed to build:\n" + q8.communicate()[0][-4000:])
    libs = {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n" + log[-4000:])
        subprocess.run([nvcc, *flags, "-shared", "-o", str(d / "lib.so"), str(d / "q4_matvec.o"),
                        str(OUT / "q8" / "q8_matvec.o")], check=True)
        (d / "lib.log").write_text(log)
        libs[name] = (d / "lib.so", d / "lib.log")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from spatialvla_tpu_torch.ops import _lib, quant

    args = sys.argv[1:]
    check_only = "--check" in args
    names = [a for a in args if a != "--check"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"no variant {unknown}; the variants: {list(VARIANTS)}")
    card = chip_smoke.card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    lib = _lib.build()
    kernel_lib = _lib.library()
    for inst, regs, st, ld in register_report(lib.with_suffix(".log")):
        print(f"{inst}: {regs} registers, spill stores {st} B, loads {ld} B", flush=True)
    loaded = {"kernel": kernel_lib}
    for name, (path, log) in (build_variants(names).items() if names else ()):
        vlib = ctypes.CDLL(str(path))
        for fn in ("q4_matvec", "q4_rmsnorm_matvec", "q4_tiled_fma", "q4_route"):
            getattr(vlib, fn).argtypes = _lib._SIGNATURES[fn]
            getattr(vlib, fn).restype = ctypes.c_int
        loaded[name] = vlib
        regs = [f"{inst} {r}" + (f" (spills {st}/{ld} B)" if st or ld else "")
                for inst, r, st, ld in register_report(log) if inst.startswith("q4_mma")]
        print(f"registers, {name}: " + ", ".join(regs), flush=True)

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    def operands(name, M, K, N, fmt):
        norm = "rmsnorm" in name
        x = randn(M, K, dtype=torch.float32 if norm else torch.bfloat16)
        nw = randn(K, std=0.1) if norm else None
        w = quant.quantize_int4(randn(K, N, dtype=torch.float32, std=0.02), GROUP[fmt])
        args = (x, nw, w["qt"], w["scale"]) if norm else (x, w["qt"], w["scale"])
        return x, nw, w, args, getattr(quant, name), getattr(quant, name + "_plain")

    worst = {}
    for tag, name, M, K, N, fmts in SHAPES:
        for fmt in fmts + (("g16",) if fmts == LM else ()):
            x, nw, w, args, kern, plain = operands(name, M, K, N, fmt)
            route = quant.q4_route(x, w["qt"], w["scale"])
            _, r16 = chip_smoke.rel_err(kern(*args), plain(*args))
            _, r32 = chip_smoke.rel_err(kern(*args, out_dtype=torch.float32),
                                        plain(*args, out_dtype=torch.float32))
            a, b = kern(*args), kern(*args)
            y_fma = chip_smoke.q4_tiled_fma(torch, x, nw, w["qt"], w["scale"])
            _, rf = chip_smoke.rel_err(y_fma, plain(*args))
            torch.cuda.synchronize()
            worst[fmt] = max(worst.get(fmt, 0.0), r32)
            print(f"check {tag} {fmt} M={M} {K}->{N}: route {route}, rel bf16 out {r16:.3e} "
                  f"fp32 out {r32:.3e}, FMA tiles rel {rf:.3e}", flush=True)
            if not (route == "tiled" and r16 < BF16_TOL and r32 < chip_smoke.Q4_FP32_TOL
                    and rf < BF16_TOL and torch.equal(a, b)):
                print(f"FAIL {tag} {fmt} M={M}: route {route}, rel {r16} / {r32} (FMA {rf}), "
                      f"identical launches {torch.equal(a, b)}")
                return 1
    print(f"checks passed; max rel fp32 out by format {worst}", flush=True)
    if check_only:
        print(f"card: {card}")
        return 0

    timer = chip_smoke.Timer(torch)
    for tag, name, M, K, N, fmts in SHAPES:
        for fmt in fmts:
            x, nw, w, args, kern, plain = operands(name, M, K, N, fmt)
            row = []
            for v in ["kernel"] + names + (["kernel"] if names else []):
                _lib.library = lambda lib=loaded[v]: lib  # the wrappers look it up at each launch
                row.append(f"{v} {timer(lambda: kern(*args)):.4f}")
            _lib.library = lambda: kernel_lib
            fma = timer(lambda: chip_smoke.q4_tiled_fma(torch, x, nw, w["qt"], w["scale"]))
            pms = timer(lambda: plain(*args))
            xl = quant._rms_bf16(x, nw, 1e-6) if nw is not None else x
            lib_ms, note = chip_smoke.library_int4pack(torch, timer, xl, w["qt"], w["scale"])
            bound, by = chip_smoke.bound(chip_smoke.nbytes_of(*args) + M * N * 2,
                                         2 * M * N * K + (4 * M * K if nw is not None else 0))
            print(f"{tag} {fmt} M={M} {K}->{N}: " + " | ".join(row) + f" ms; FMA tiles {fma:.4f} "
                  f"plain {pms:.4f} library{' (matmul alone)' if nw is not None else ''} "
                  f"{lib_ms} ms ({note}); bound {bound:.4f} ms ({by})", flush=True)

    # qmatmul's path above 512 rows against the kernel, for the crossover
    for K, N in CROSSOVER:
        for fmt in LM:
            w = quant.quantize_int4(randn(K, N, dtype=torch.float32, std=0.02), GROUP[fmt])
            for M in CROSSOVER_M:
                x = randn(M, K)
                d = timer(lambda: quant.dequant_matmul(x, w))
                k = timer(lambda: quant.q4_matvec(x, w["qt"], w["scale"])) if M <= 512 else None
                lib_ms, _ = chip_smoke.library_int4pack(torch, timer, x, w["qt"], w["scale"])
                print(f"crossover {fmt} M={M} {K}->{N}: kernel {k} ms, dequantize + matmul "
                      f"{d:.4f} ms, library {lib_ms} ms", flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
