#!/usr/bin/env python3
"""The flash-attention backward kernels (csrc/flash_attention.cu) on an NVIDIA GPU.

    python3 scripts/bench_flash_bwd.py [--check]

Builds the kernel library and prints the compiler's registers, shared memory
and spills of every backward kernel (the tensor-core ``flash_bwd_mma_kernel
<DMAX, dk/dv>`` and the FMA kernels), then holds
``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` to their plain
versions in bf16 (tensor cores) and fp32 (FMA) on the training path's shape
(B=2, T=320, 8 / 4 heads, D=256, softcap 50, prefix 277, one row padded to
301; window 4096 and none), at T=2048, and on small cases (head dims 32-128,
a group of 3, ragged lengths, a window of 17 that leaves whole tiles dead),
with two launches of each bf16 call bit-identical. Tolerance
max|kernel - plain| / max|plain|: 2e-2 bf16, 1e-4 fp32 (chip_smoke.py's
FLASH_TOL). Prints each call's launch plan (route, grid, blocks an SM).
Without ``--check`` it then times, at the three large shapes, the kernel,
the FMA kernels in bf16 (the route bf16 took before), and the plain version,
with chip_smoke.py's Timer (CUDA graphs, L2 flushed), beside the bound, the
achieved TFLOP/s and the share of the bound. Exits 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def ptxas_report(log: str, kind: str = "flash_bwd") -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel whose name holds ``kind`` (the flash backward's by default) in an
    nvcc -Xptxas -v log."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kind in name:
            rows.append((readable(name), int(m.group(1)), *spills))
            name = None
    return rows


def readable(mangled: str) -> str:
    m = re.search(r"(flash_(?:fwd|bwd)\w*?_kernel)I(.*?)EEv", mangled)
    if not m:
        return mangled
    kernel, args = m.groups()
    dtype = "bf16" if "bfloat16" in args else ("fp32" if args.startswith("f") else "")
    ints = re.findall(r"L[ib](\d+)E", args)
    if kernel == "flash_bwd_mma_kernel":
        return f"{kernel}<D {ints[0]}, {'dk/dv' if ints[1] == '1' else 'dq'}>"
    if kernel == "flash_fwd_mma_kernel":
        return f"{kernel}<D {ints[0]}>"
    return f"{kernel}<{dtype}, D {ints[0]}>"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="build, report and check; no timing")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from spatialvla_tpu_torch.ops import _lib
    from spatialvla_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | {card}", flush=True)
    path = _lib.build()
    _lib.library()
    for kernel, regs, st, ld in ptxas_report(path.with_suffix(".log").read_text()):
        print(f"ptxas {kernel}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    g = torch.Generator(device="cuda").manual_seed(5)
    # tag: B, T, Nq, Nkv, D, cap, window, prefix, valid, timed
    cases = [
        ("T320_window4096", 2, 320, 8, 4, 256, 50.0, 4096, [277, 277], [320, 301], True),
        ("T320_global", 2, 320, 8, 4, 256, 50.0, None, [277, 277], [320, 301], True),
        ("T2048_window4096", 2, 2048, 8, 4, 256, 50.0, 4096, [256, 256], [2048, 1900], True),
        ("D32_ragged", 2, 77, 6, 3, 32, 50.0, 33, [13, 0], [77, 70], False),
        ("D64_gqa3", 2, 96, 12, 4, 64, None, None, [40, 77], [96, 81], False),
        ("D128_mqa", 1, 130, 8, 1, 128, 30.0, None, [0], [130], False),
        ("D144_window", 2, 64, 4, 2, 144, 50.0, 24, [50, 3], [60, 64], False),
        ("D256_window17", 2, 320, 8, 4, 256, 50.0, 17, [0, 5], [320, 310], False),
    ]
    ok = True
    for tag, B, T, Nq, Nkv, D, cap, window, prefix, valid, timed in cases:
        lens = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (prefix, valid, [0] * B)]
        kw = dict(scale=D ** -0.5, logit_softcap=cap, window=window, causal=True)
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and T > 320:
                continue
            rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
            q, do = rnd(B, T, Nq, D), rnd(B, T, Nq, D)
            k, v = rnd(B, T, Nkv, D), rnd(B, T, Nkv, D)
            out, lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
            delta = fa.attention_delta(out, do)
            a = (q, k, v, do, lse, delta, *lens)
            dq = fa.flash_attention_bwd_dq(*a, **kw)
            dk, dv = fa.flash_attention_bwd_dkv(*a, **kw)
            rq = fa.flash_attention_bwd_dq_plain(*a, **kw)
            rk, rv = fa.flash_attention_bwd_dkv_plain(*a, **kw)
            torch.cuda.synchronize()
            errs = [cs.rel_err(x, y)[1] for x, y in ((dq, rq), (dk, rk), (dv, rv))]
            tol = cs.FLASH_TOL[str(dtype).split(".")[-1]]
            same = True
            if dtype == torch.bfloat16:
                dq2 = fa.flash_attention_bwd_dq(*a, **kw)
                dk2, dv2 = fa.flash_attention_bwd_dkv(*a, **kw)
                same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
                fq, fk, fv = fa.flash_attention_bwd_fma(*a, **kw)  # the FMA kernels in bf16
                errs += [cs.rel_err(x, y)[1] for x, y in ((fq, rq), (fk, rk), (fv, rv))]
            plans = {n: fa.bwd_plan(n, q, k) for n in ("dq", "dkv")}
            good = all(e < tol for e in errs) and same and all(
                torch.isfinite(t.float()).all().item() for t in (dq, dk, dv))
            ok &= good
            print(f"{tag} {str(dtype)[6:]}: rel err dq {errs[0]:.3e} dk {errs[1]:.3e} "
                  f"dv {errs[2]:.3e} (bound {tol})"
                  + (f", FMA bf16 dq {errs[3]:.3e} dk {errs[4]:.3e} dv {errs[5]:.3e}"
                     if len(errs) > 3 else "")
                  + f", identical twice {same}; "
                  + "; ".join(f"{n} {p['route']} grid {p['grid']} x {p['threads']} threads, "
                              f"{p['smem_bytes']} B smem, {p['blocks_per_sm']} blocks/SM, "
                              f"clusters of {p['cluster']}"
                              for n, p in plans.items())
                  + ("" if good else "  <-- FAIL"), flush=True)
            split = fa.bwd_split(B, T, Nkv, Nq // Nkv, sms)
            if dtype == torch.bfloat16 and plans["dkv"]["grid"] != (-(-T // 32), Nkv * split, B):
                print(f"{tag}: dk/dv grid {plans['dkv']['grid']}, bwd_split {split}  <-- FAIL")
                ok = False
            if args.check or not timed or dtype != torch.bfloat16:
                continue
            timer = cs.Timer(torch)
            pairs = int(fa.attention_mask(*lens, T, T, window=window, causal=True).sum()) * Nq
            for n, fn, fma, plain, ops, outs in (
                ("dq", lambda: fa.flash_attention_bwd_dq(*a, **kw),
                 lambda: fa.flash_attention_bwd_fma(*a, **kw, dkv=False),
                 lambda: fa.flash_attention_bwd_dq_plain(*a, **kw), 6 * D * pairs, (dq,)),
                ("dkv", lambda: fa.flash_attention_bwd_dkv(*a, **kw),
                 lambda: fa.flash_attention_bwd_fma(*a, **kw, dq=False),
                 lambda: fa.flash_attention_bwd_dkv_plain(*a, **kw), 8 * D * pairs, (dk, dv)),
            ):
                t_plain, t_k, t_fma, t_k2 = (timer(plain), timer(fn), timer(fma), timer(fn))
                ms = min(t_k, t_k2)
                bms, by = cs.bound(cs.nbytes_of(*a, *outs), ops)
                print(f"  {tag} {n}: kernel {t_k:.4f} / {t_k2:.4f} ms, FMA bf16 {t_fma:.4f} ms, "
                      f"plain {t_plain:.4f} ms; bound {bms:.4f} ms ({by}); "
                      f"{ops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3%} of the bound | {card}",
                      flush=True)
    print("bench_flash_bwd: " + ("ok" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
