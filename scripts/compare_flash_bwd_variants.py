#!/usr/bin/env python3
"""Time patched copies of csrc/flash_attention.cu's tensor-core backward
beside the kernel itself, on an NVIDIA GPU, to see where its time goes.

    python3 scripts/compare_flash_bwd_variants.py [--against FILE] [variant ...]

Each variant (all of VARIANTS, or those named) is the source with a few
lines replaced (with --against, also FILE, another flash_attention.cu such
as an earlier version, in its place), built with nvcc into its own library
under ``_build/variants_flash/`` and loaded in place of the port's library
while it is timed; its flash_bwd_mma_kernel instances' registers and spills
are printed first. Most variants are diagnostics that compute a wrong
result on purpose, each leaving one part of a tile's work out: the S and dP
products, the softcap's arithmetic, the per-element mask, the dS (and P)
products, or the loads of every tile after the first. Two keep the result:
dq reading its q and dO fragments from shared memory every tile instead of
keeping them in registers, and dk/dv without the cluster split. Each runs
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` in bf16 at the
training path's shape (B=2, T=320, 8 / 4 heads, D=256, softcap 50, prefix
277, one row padded to 301, window 4096) and at T=2048, with chip_smoke's
CUDA-graph timer, the kernel first and last; its error against the plain
version is printed beside the time. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

CSRC = ROOT / "spatialvla_tpu_torch" / "csrc"
OUT = ROOT / "spatialvla_tpu_torch" / "_build" / "variants_flash"
AGAINST = "against"  # the --against source
VARIANTS = {  # name: [(text in flash_attention.cu, its replacement)]
    "kernel": [],
    "no S, dP products": [("      if (kk * 16 < D) {\n        unsigned a[4], bb[4];",
                           "      if (kk * 16 < 0) {\n        unsigned a[4], bb[4];")],
    "no softcap arithmetic": [("  const bool capped = g.cap > 0.f;", "  const bool capped = false;")],
    "no mask": [("        if constexpr (!kFull) {", "        if constexpr (false) {")],
    "no dS, P products": [("        if (np * 16 < Dh && col < D) {", "        if (np * 16 < 0) {")],
    "no loads after the first tile": [("    if (jn < n) stage_inner(jn, st ^ 1);",
                                       "    if (jn < 0) stage_inner(jn, st ^ 1);")],
    # variants that keep the result: dq reading its own q and dO fragments
    # from shared memory every tile instead of keeping them in registers;
    # dk/dv without the cluster split (one block a kv head's q heads, at
    # every grid)
    "dq: fragments from shared memory": [("constexpr bool kDqCacheOwn = true;",
                                          "constexpr bool kDqCacheOwn = false;")],
    "no cluster split": [("  if (static_cast<long>((g.Tk + kOwn - 1) / kOwn) * g.Nkv * B >= sm_count()) return 1;",
                          "  return 1;")],
}
# tag, T, window, prefix, valid
SHAPES = (("T320_window4096", 320, 4096, [277, 277], [320, 301]),
          ("T2048_window4096", 2048, 4096, [256, 256], [2048, 1900]))


def build_all(nvcc, nvcc_flags, names, against=None, variants=None, out=OUT):
    """One library a variant (of ``variants``, VARIANTS by default), every
    nvcc started together, into ``out``. Returns {name: (library, nvcc's
    report)}."""
    variants = VARIANTS if variants is None else variants
    source = (CSRC / "flash_attention.cu").read_text()
    shutil.rmtree(out, ignore_errors=True)
    jobs = {}
    for i, name in enumerate(names):
        d = out / f"v{i}"
        d.mkdir(parents=True)
        text = Path(against).read_text() if name == AGAINST else source
        for old, new in variants.get(name, []):
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: the patched text is not in the source once")
            text = text.replace(old, new)
        (d / "flash_attention.cu").write_text(text)
        shutil.copy(CSRC / "common.cuh", d)
        jobs[name] = (d, subprocess.Popen(
            [nvcc, *nvcc_flags, "-c", "-Xptxas", "-v", "-o", str(d / "flash.o"),
             str(d / "flash_attention.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r} failed to build:\n" + log[-4000:])
        subprocess.run([nvcc, *nvcc_flags, "-shared", "-o", str(d / "lib.so"), str(d / "flash.o")],
                       check=True)
        libs[name] = (d / "lib.so", log)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from bench_flash_bwd import ptxas_report
    from spatialvla_tpu_torch.ops import _lib
    from spatialvla_tpu_torch.ops import flash_attention as fa

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
        for fn in ("flash_bwd_dq", "flash_bwd_dkv"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
        regs = [f"{k.split('<')[1][:-1]}: {r}" + (f" (spills {st}/{ld} B)" if st or ld else "")
                for k, r, st, ld in ptxas_report(log) if "mma" in k and "D 256" in k]
        print(f"registers, {name}: " + "; ".join(regs), flush=True)

    g = torch.Generator(device="cuda").manual_seed(5)
    timer = chip_smoke.Timer(torch)
    B, Nq, Nkv, D = 2, 8, 4, 256
    for tag, T, window, prefix, valid in SHAPES:
        rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
        q, do, k, v = rnd(B, T, Nq, D), rnd(B, T, Nq, D), rnd(B, T, Nkv, D), rnd(B, T, Nkv, D)
        lens = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (prefix, valid, [0, 0])]
        kw = dict(scale=D ** -0.5, logit_softcap=50.0, window=window, causal=True)
        out, lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
        a = (q, k, v, do, lse, fa.attention_delta(out, do), *lens)
        ref_dq = fa.flash_attention_bwd_dq_plain(*a, **kw)
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_plain(*a, **kw)
        for kernel, fn in (("dq", fa.flash_attention_bwd_dq), ("dkv", fa.flash_attention_bwd_dkv)):
            row = []
            for v_name in names + ["kernel"]:
                _lib.library = lambda lib=loaded[v_name]: lib  # the wrappers look it up each launch
                got = fn(*a, **kw)
                err = (chip_smoke.rel_err(got, ref_dq)[1] if kernel == "dq" else
                       max(chip_smoke.rel_err(got[0], ref_dk)[1],
                           chip_smoke.rel_err(got[1], ref_dv)[1]))
                row.append(f"{v_name} {timer(lambda: fn(*a, **kw)):.4f} ms (rel {err:.1e})")
            print(f"{kernel} {tag}: " + " | ".join(row), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
