#!/usr/bin/env python3
"""The flash-attention forward (csrc/flash_attention.cu) on an NVIDIA GPU.

    python3 scripts/bench_flash_fwd.py [--check] [--variants] [--no-library]

Builds the kernel library and prints the compiler's registers, shared memory
and spills of every forward kernel (the tensor-core ``flash_fwd_mma_kernel
<DMAX>`` and the FMA ``flash_fwd_kernel``), then holds
``flash_attention_fwd`` to its plain version in bf16 (tensor cores) and fp32
(FMA), and ``flash_attention_fwd_fma`` in bf16, on the training path's shape
(B=2, T=320, 8 / 4 heads, D=256, softcap 50, prefix 277, one row padded to
301; window 4096 and none), at T=2048, on the flash prefill's (B=1, 277
tokens, bidirectional prefix), and on small cases (head dims 32-144, a group
of 3, ragged lengths, a q offset, a window of 17 that leaves whole tiles
dead), with two launches of each bf16 call bit-identical. Tolerance
max|kernel - plain| / max|plain|: 2e-2 bf16, 1e-4 fp32 (chip_smoke.py's
FLASH_TOL), the LSE within 1e-3. Prints each call's launch plan (route,
grid, q rows a block, blocks an SM, registers, local bytes). Without
``--check`` it then times, at the training shapes, T=2048 and the prefill,
the kernel (first and last), the FMA kernel in bf16 (the route bf16 took
before), the plain version and torch.compile(flex_attention)
(chip_smoke.library_flex), with chip_smoke.py's Timer (CUDA graphs, L2
flushed), beside the bound, the achieved TFLOP/s and the share of the
bound. ``--variants`` also builds patched copies of the source (VARIANTS:
2 warps a block, the output rescaled every tile; and
diagnostics that leave a part of a tile's work out, so compute a wrong
result) into ``_build/variants_flash_fwd/`` and times each beside the
kernel. Exits 1 on
a mismatch. ``--no-library`` leaves flex_attention out.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

VARIANTS = {  # name: [(text in flash_attention.cu, its replacement)]
    "kernel": [],
    # 2 warps (32 q rows) a block: 160 blocks at T=320
    "2 warps a block": [("constexpr int kFwdWarps = 4;", "constexpr int kFwdWarps = 2;")],
    "rescale every tile": [("      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {",
                            "      if (true) {")],
    # diagnostics: a wrong result on purpose
    "no S products": [("      for (int kk = 0; kk < DMAX / 16; ++kk) {\n        const int c = kk & 1",
                       "      for (int kk = 0; kk < 0; ++kk) {\n        const int c = kk & 1")],
    "no P.V products": [("      for (int i = 0; i < NPV; ++i) {", "      for (int i = 0; i < 0; ++i) {")],
    "no loads after the first tile": [("    if (jn < nt) stage(jn, st ^ 1);",
                                       "    if (jn < 0) stage(jn, st ^ 1);")],
}
# tag: B, T, Nq, Nkv, D, cap, window, prefix, valid, timed
CASES = [
    ("T320_window4096", 2, 320, 8, 4, 256, 50.0, 4096, [277, 277], [320, 301], True),
    ("T320_global", 2, 320, 8, 4, 256, 50.0, None, [277, 277], [320, 301], True),
    ("T2048_window4096", 2, 2048, 8, 4, 256, 50.0, 4096, [256, 256], [2048, 1900], True),
    ("prefill_T277", 1, 277, 8, 4, 256, 50.0, 4096, [277], [277], True),
    ("D32_ragged", 2, 77, 6, 3, 32, 50.0, 33, [13, 0], [77, 70], False),
    ("D64_gqa3", 2, 96, 12, 4, 64, None, None, [40, 77], [96, 81], False),
    ("D128_mqa", 1, 130, 8, 1, 128, 30.0, None, [0], [130], False),
    ("D144_window", 2, 64, 4, 2, 144, 50.0, 24, [50, 3], [60, 64], False),
    ("D256_window17", 2, 320, 8, 4, 256, 50.0, 17, [0, 5], [320, 310], False),
]


def fmt_plan(p: dict) -> str:
    return (f"{p['route']} grid {p['grid']} x {p['threads']} threads ({p['rows']} q rows), "
            f"clusters of {p['cluster']}, {p['smem_bytes']} B smem, {p['blocks_per_sm']} "
            f"blocks/SM, {p['registers']} registers, {p['local_bytes']} B local")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="build, report and check; no timing")
    ap.add_argument("--variants", action="store_true", help="also time the patched copies")
    ap.add_argument("--no-library", action="store_true", help="leave flex_attention out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from bench_flash_bwd import ptxas_report
    from spatialvla_tpu_torch.ops import _lib
    from spatialvla_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__}",
          flush=True)
    path = _lib.build()
    _lib.library()
    for kernel, regs, st, ld in ptxas_report(path.with_suffix(".log").read_text(), "flash_fwd"):
        print(f"ptxas {kernel}: {regs} registers, spill stores {st} B, spill loads {ld} B")

    g = torch.Generator(device="cuda").manual_seed(7)
    ok, timed_cases = True, []
    for tag, B, T, Nq, Nkv, D, cap, window, prefix, valid, timed in CASES:
        lens = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (prefix, valid, [0] * B)]
        kw = dict(scale=D ** -0.5, logit_softcap=cap, window=window, causal=True)
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and T > 320:
                continue
            rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
            q, k, v, do = rnd(B, T, Nq, D), rnd(B, T, Nkv, D), rnd(B, T, Nkv, D), rnd(B, T, Nq, D)
            out, lse = fa.flash_attention_fwd(q, k, v, *lens, **kw)
            ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
            torch.cuda.synchronize()
            rows = fa.allowed_rows(*lens, T, T, window=window, causal=True)
            if not bool(rows.all()):
                raise SystemExit(f"{tag}: a query row has no allowed key")
            errs = {"out": cs.rel_err(out, ref_out)[1]}
            lse_err = {"lse": (lse - ref_lse).abs().max().item()}
            tol = cs.FLASH_TOL[str(dtype).split(".")[-1]]
            plan = fa.fwd_plan(q, k)
            good = plan["route"] == ("mma" if dtype == torch.bfloat16 else "fma")
            if dtype == torch.bfloat16:
                out2, lse2 = fa.flash_attention_fwd(q, k, v, *lens, **kw)
                same = torch.equal(out, out2) and torch.equal(lse, lse2)
                fo, fl = fa.flash_attention_fwd_fma(q, k, v, *lens, **kw)
                errs["FMA bf16 out"] = cs.rel_err(fo, ref_out)[1]
                lse_err["FMA bf16 lse"] = (fl - ref_lse).abs().max().item()
                good &= same and plan["rows"] == fa.FWD_ROWS and plan["cluster"] == 1
                good &= plan["grid"] == (-(-T // fa.FWD_ROWS), Nq, B)
                good &= plan["local_bytes"] == 0
            else:
                same = None
            good &= all(e < tol for e in errs.values()) and all(e < 1e-3 for e in lse_err.values())
            good &= bool(torch.isfinite(out.float()).all())
            ok &= good
            print(f"{tag} {str(dtype)[6:]}: rel err "
                  + " ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " max|d| "
                  + " ".join(f"{n} {e:.3e}" for n, e in lse_err.items())
                  + f" (bounds {tol}, 1e-3), identical twice {same}; {fmt_plan(plan)}"
                  + ("" if good else "  <-- FAIL"), flush=True)
            if timed and dtype == torch.bfloat16:
                timed_cases.append((tag, q, k, v, do, lens, kw, ref_out, ref_lse))
    if args.check:
        print("bench_flash_fwd: " + ("ok" if ok else "FAILED"), flush=True)
        return 0 if ok else 1

    timer = cs.Timer(torch)

    def ops_and_bytes(q, k, v, lens, kw, out, lse):
        B, T, Nq, D = q.shape
        pairs = int(fa.attention_mask(*lens, T, T, window=kw["window"], causal=True).sum()) * Nq
        return 4 * D * pairs, cs.nbytes_of(q, k, v, *lens, out, lse)

    for tag, q, k, v, do, lens, kw, ref_out, ref_lse in timed_cases:
        fn = lambda: fa.flash_attention_fwd(q, k, v, *lens, **kw)  # noqa: E731
        t_plain = timer(lambda: fa.flash_attention_fwd_plain(q, k, v, *lens, **kw))
        t_k = timer(fn)
        t_fma = timer(lambda: fa.flash_attention_fwd_fma(q, k, v, *lens, **kw))
        t_k2 = timer(fn)
        ms = min(t_k, t_k2)
        ops, nbytes = ops_and_bytes(q, k, v, lens, kw, ref_out, ref_lse)
        bms, by = cs.bound(nbytes, ops)
        print(f"  {tag} fwd: kernel {t_k:.4f} / {t_k2:.4f} ms, FMA bf16 {t_fma:.4f} ms, plain "
              f"{t_plain:.4f} ms; bound {bms:.4f} ms ({by}); {ops / ms / 1e9:.1f} TFLOP/s, "
              f"{bms / ms:.3%} of the bound | {card}", flush=True)

    if args.variants:
        from compare_flash_bwd_variants import build_all

        out_dir = ROOT / "spatialvla_tpu_torch" / "_build" / "variants_flash_fwd"
        loaded = {}
        for name, (lib_path, log) in build_all(_lib._nvcc(), _lib.NVCC_FLAGS, list(VARIANTS),
                                               variants=VARIANTS, out=out_dir).items():
            lib = ctypes.CDLL(str(lib_path))
            lib.flash_fwd.argtypes = _lib._SIGNATURES["flash_fwd"]
            lib.flash_fwd.restype = ctypes.c_int
            loaded[name] = lib
            regs = [f"{kern}: {r}" + (f" (spills {s1}/{s2} B)" if s1 or s2 else "")
                    for kern, r, s1, s2 in ptxas_report(log, "flash_fwd_mma")]
            print(f"registers, {name}: " + "; ".join(regs), flush=True)
        library = _lib.library
        try:
            for tag, q, k, v, _, lens, kw, ref_out, _ in timed_cases:
                row = []
                for name in list(VARIANTS) + ["kernel"]:
                    # the wrapper looks the library up at each launch
                    _lib.library = lambda lib=loaded[name]: lib
                    got, _ = fa.flash_attention_fwd(q, k, v, *lens, **kw)
                    err = cs.rel_err(got, ref_out)[1]
                    t = timer(lambda: fa.flash_attention_fwd(q, k, v, *lens, **kw))
                    row.append(f"{name} {t:.4f} ms (rel {err:.1e})")
                print(f"variants {tag}: " + " | ".join(row), flush=True)
        finally:
            _lib.library = library
    # the library's call last: torch.compile and its CUDA graphs
    for tag, q, k, v, do, lens, kw, ref_out, ref_lse in [] if args.no_library else timed_cases:
        ref_bwd = fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, do, *lens, **kw)
        flex, note = cs.library_flex(torch, timer, q, k, v, do, lens, kw,
                                     (ref_out, ref_lse, *ref_bwd))
        print(f"  {tag} flex_attention: forward {flex['fwd']} ms, backward (dq, dk, dv) "
              f"{flex['bwd']} ms; {note} | {card}", flush=True)
    print(f"card: {card}")
    print("bench_flash_fwd: " + ("ok" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
