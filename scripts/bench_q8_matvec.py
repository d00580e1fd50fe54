#!/usr/bin/env python3
"""Time and check the few-row matvec kernels of csrc/q8_matvec.cu on an
NVIDIA GPU: int8 (q8_matvec, q8_rmsnorm_matvec) and the packed int4
instances, per channel and grouped, that q4_matvec / q4_rmsnorm_matvec take
at M <= 16. The short loop for working on that file.

    python3 scripts/bench_q8_matvec.py
    python3 scripts/bench_q8_matvec.py --residual

Builds the kernel library, prints each qmatvec_kernel instance's registers
and spills from nvcc's report (``_build/*.log``), checks every rows
instance (M = 1..16), ragged N and chunked K of int8, int4 per channel and
int4 in groups of 128 and 16 columns against the plain versions, checks
that two launches give identical bits, then times the decode shapes (the
head, o, down, qkv and gate|up; M = 1 and 16, and the int8 o at M = 2) of
int8, int4 and int4-g128 side by side with chip_smoke's CUDA-graph timer
(L2 flushed before each run): the kernel, its plain version and
torch._weight_int8pack_mm / _weight_int4pack_mm (for the RMSNorm variants
on the normed x, the matmul alone). Max relative error to plain must stay
below 1e-2 (bf16 out). ``--residual`` instead times the residual kernels
(q8_residual_rmsnorm_matvec, q4_residual_rmsnorm_matvec: norm_residual
folded into the RMSNorm matvec) at every rows instance (M = 1, 2, 4; at 8
and 16 rows it lost to the pair and was taken out) of qkv (2304 -> 4096)
and gate|up (2304 -> 18432) in int8, int4 and int4-g128, beside the pair
of launches they replace (norm_residual +
the RMSNorm matvec, in one graph) and the RMSNorm matvec alone, in turns
(pair, kernel, kernel, pair), each checked against the plain version.
Needs CUDA and nvcc.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOL = 1e-2
# (format, name, M, K, N): chip_smoke's q8 shapes, the o projection at M =
# 1, 2, 16, then the q4 decode shapes (head, o, down, qkv, gate|up) at M = 1
# and 16, per channel and in 128-column groups
SHAPES = (
    ("int8", "q8_matvec", 1, 2304, 8194), ("int8", "q8_matvec", 16, 9216, 2304),
    ("int8", "q8_matvec", 1, 2048, 2304), ("int8", "q8_matvec", 1, 9216, 2304),
    ("int8", "q8_matvec", 2, 2048, 2304), ("int8", "q8_matvec", 16, 2048, 2304),
    ("int8", "q8_rmsnorm_matvec", 1, 2304, 4096), ("int8", "q8_rmsnorm_matvec", 1, 2304, 18432),
    ("int8", "q8_rmsnorm_matvec", 16, 2304, 4096), ("int8", "q8_rmsnorm_matvec", 16, 2304, 18432),
) + tuple((fmt, name, M, K, N) for fmt in ("int4", "int4-g128") for M in (1, 16)
          for name, K, N in (("q4_matvec", 2304, 8194), ("q4_matvec", 2048, 2304),
                             ("q4_matvec", 9216, 2304), ("q4_rmsnorm_matvec", 2304, 4096),
                             ("q4_rmsnorm_matvec", 2304, 18432)))
# format: (quantize, the (K, N) checked at every M = 1..16): ragged N, K
# staged in chunks at 8 and 16 rows (9216), K of no chunk or lane multiple
# (2320 int8; 2336 int4, 73 packed units), K = 2048 in 16 groups
FORMATS = {
    "int8": (None, ((2304, 40), (9216, 100), (2320, 4100))),
    "int4": (None, ((2304, 40), (9216, 100), (2336, 4100))),
    "int4-g128": (128, ((2304, 40), (9216, 100), (2048, 4100))),
    "int4-g16": (16, ((2304, 40), (9216, 100))),
}


def register_report(log: Path) -> list:
    """(instance, registers, spill stores, spill loads) of each
    qmatvec_kernel<MR, kNorm, kInt4, kGrouped, kResid, kGelu> in nvcc's
    -Xptxas -v output ("resid": the residual instances, "gelu": the gelu
    epilogue's)."""
    rows, current = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"qmatvec_kernelILi(\d+)ELb([01])ELb([01])ELb([01])E"
                          r"(?:Lb([01])E)?(?:Lb([01])E)?", m.group(1))
            fmt = None if not k else ("int8" if k.group(3) == "0" else
                                      "int4-grouped" if k.group(4) == "1" else "int4")
            current = (f"{fmt} MR={k.group(1)} norm={k.group(2)}"
                       + (" resid" if k.group(5) == "1" else "")
                       + (" gelu" if k.group(6) == "1" else "") if k else None)
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


def residual_rows(torch, timer, randn, qweight) -> int:
    """The residual kernels beside the pair they replace (see the module
    docstring); returns 1 on a failed check."""
    import chip_smoke
    from spatialvla_tpu_torch.ops import decode_step as ds
    from spatialvla_tpu_torch.ops import quant

    for fmt in ("int8", "int4", "int4-g128"):
        for N in (4096, 18432):
            for M in (1, 2, 4):
                K = 2304
                h_in, upd = randn(M, K, dtype=torch.float32, std=8.0), randn(M, K)
                post, nw, w = randn(K, std=0.1), randn(K, std=0.1), qweight(N, K, fmt)
                args = (h_in, upd, post, nw, w["qt"], w["scale"])
                h_out, h_ref = torch.empty_like(h_in), torch.empty_like(h_in)
                r = chip_smoke.rel_err(quant.residual_rmsnorm_matvec(*args, h_out=h_out),
                                       quant.residual_rmsnorm_matvec_plain(*args, h_out=h_ref))[1]
                rh = chip_smoke.rel_err(h_out, h_ref)[1]
                if not (r < 2e-2 and rh < 1e-2):
                    print(f"FAIL residual {fmt} M={M} N={N}: rel {r:.3e}, h_out {rh:.3e}")
                    return 1
                hh = h_in.clone()
                kern = lambda: quant.residual_rmsnorm_matvec(*args, h_out=h_out)  # noqa: E731
                pair = lambda: (ds.norm_residual(hh, upd, post, eps=1e-6),  # noqa: E731
                                quant.rmsnorm_matvec(hh, nw, w["qt"], w["scale"]))
                alone = lambda: quant.rmsnorm_matvec(hh, nw, w["qt"], w["scale"])  # noqa: E731
                p1, k1, k2, p2 = timer(pair), timer(kern), timer(kern), timer(pair)
                a = timer(alone)
                print(f"residual {fmt} M={M} 2304->{N}: kernel {min(k1, k2):.4f} ms "
                      f"({k1:.4f}, {k2:.4f}), norm_residual + rmsnorm_matvec {min(p1, p2):.4f} ms "
                      f"({p1:.4f}, {p2:.4f}), rmsnorm_matvec alone {a:.4f} ms; rel {r:.2e}, "
                      f"h_out {rh:.2e}", flush=True)
    return 0


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
        print(f"qmatvec_kernel {inst}: {regs} registers, spill stores {st} B, loads {ld} B")

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    def qweight(N, K, fmt):
        w = randn(K, N, dtype=torch.float32, std=0.02)
        if fmt == "int8":
            return quant.quantize_int8(w)
        return quant.quantize_int4(w, FORMATS[fmt][0])

    if sys.argv[1:] == ["--residual"]:
        rc = residual_rows(torch, chip_smoke.Timer(torch), randn, qweight)
        print(f"card: {card}")
        return rc

    # every rows instance and its edges, ragged N, chunked K, both x types
    for fmt, (_, shapes) in FORMATS.items():
        mv, nmv = (quant.q8_matvec, quant.q8_rmsnorm_matvec) if fmt == "int8" else \
            (quant.q4_matvec, quant.q4_rmsnorm_matvec)
        worst = 0.0
        for M in range(1, 17):
            for K, N in shapes:
                w = qweight(N, K, fmt)
                for x_dtype in (torch.float32, torch.bfloat16):
                    x, nw = randn(M, K, dtype=x_dtype), randn(K, std=0.1)
                    args = (x, w["qt"], w["scale"])
                    r1 = chip_smoke.rel_err(mv(*args), quant.matvec_plain(*args))[1]
                    r2 = chip_smoke.rel_err(nmv(x, nw, *args[1:]),
                                            quant.rmsnorm_matvec_plain(x, nw, *args[1:]))[1]
                    worst = max(worst, r1, r2)
                    if not (r1 < TOL and r2 < TOL):
                        print(f"FAIL {fmt} M={M} K={K} N={N} x {x_dtype}: "
                              f"rel {r1:.3e} / {r2:.3e}")
                        return 1
                    if fmt != "int8" and quant.q4_route(x, w["qt"], w["scale"]) != "rows":
                        print(f"FAIL {fmt} M={M} K={K}: not the few-row kernel")
                        return 1
        print(f"check {fmt}: M=1..16 x (K, N) in {shapes} x fp32/bf16 x: max rel {worst:.3e} "
              f"(bound {TOL})", flush=True)
        x, w = randn(16, 9216, dtype=torch.float32), qweight(2304, 9216, fmt)
        a, b = mv(x, w["qt"], w["scale"]), mv(x, w["qt"], w["scale"])
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            print(f"FAIL {fmt}: two launches differ")
            return 1

    timer = chip_smoke.Timer(torch)
    for fmt, name, M, K, N in SHAPES:
        norm = "rmsnorm" in name
        x, nw, w = randn(M, K, dtype=torch.float32 if norm else torch.bfloat16), randn(K, std=0.1), \
            qweight(N, K, fmt)
        args = (x, nw, w["qt"], w["scale"]) if norm else (x, w["qt"], w["scale"])
        kern = getattr(quant, name)
        plain = getattr(quant, name + "_plain")
        d, r = chip_smoke.rel_err(kern(*args), plain(*args))
        ms, pms = timer(lambda: kern(*args)), timer(lambda: plain(*args))
        xl = quant._rms_bf16(x, nw, 1e-6) if norm else x
        library = chip_smoke.library_int8pack if fmt == "int8" else chip_smoke.library_int4pack
        lib, _ = library(torch, timer, xl, w["qt"], w["scale"])
        nbytes = chip_smoke.nbytes_of(*args) + M * N * 2
        bound, by = chip_smoke.bound(nbytes, 2 * M * N * K)
        print(f"{name} {fmt} M={M} {K}->{N}: kernel {ms:.4f} ms plain {pms:.4f} ms library "
              f"{'(matmul alone) ' if norm else ''}{lib} ms bound {bound:.4f} ms ({by}) "
              f"rel err {r:.3e}", flush=True)
        if not r < TOL:
            print(f"FAIL {name} M={M}: rel err {r}")
            return 1
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
