"""The port's CUDA kernels against their plain PyTorch versions on an NVIDIA
GPU, and the serving path through them.

This file imports no jax, so it also runs on a machine without it; there
the repository's conftest (which imports jax) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Without a GPU every test skips. Tolerance: max|kernel - plain| / max|plain|
below 1e-2 for each kernel (the kernels round where the plain versions do;
what differs is the fp32 summation order), below 5e-3 for the grouped int4
matvecs, the int4 tensor-core route and the residual kernels with fp32
outputs, below 0.02 for a whole decode step (the JAX package's bound for the
fused step at batch 1). The decode loop replayed as a CUDA graph gives the
eager loop's ids and margins exactly, and the split engine's persistent
decode batch the eager state bit for bit. The flash kernels: 1e-4 fp32, 2e-2
bf16 (their FLASH_TOL), the LSE within 1e-3; the bf16 forward and backward
on tensor cores give identical bits when launched twice.
"""
import dataclasses

import numpy as np
import pytest
import torch

from spatialvla_tpu_torch import Gemma2Config, SpatialVLAPolicy, spatialvla_tiny
from spatialvla_tpu_torch.models import gemma2
from spatialvla_tpu_torch.models import spatialvla as sv
from spatialvla_tpu_torch.ops import decode_step as ds
from spatialvla_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda

DEV = "cuda"


@pytest.fixture(autouse=True)
def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA only")


def _gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def _randn(g, *shape, dtype=torch.bfloat16, std=1.0):
    return (torch.randn(shape, generator=g, device=DEV) * std).to(dtype)


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12)).item()


# every rows instance of the int8 kernels (1, 2, 4, 8, 16) and both of its
# edges; N that no tile of channels divides; K = 9216, which at 16 rows is
# staged in chunks; K = 2320, a multiple of 16 but of no chunk
Q8_ROWS = [1, 2, 3, 4, 5, 8, 9, 16]


@pytest.mark.parametrize("M", Q8_ROWS)
@pytest.mark.parametrize("K,N", [(2304, 8194), (9216, 2304), (2320, 4100), (64, 40)])
@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.float32)])
def test_q8_matvec(M, K, N, x_dtype, out_dtype):
    g = _gen(0)
    x = _randn(g, M, K, dtype=x_dtype)
    w = quant.quantize_int8(_randn(g, K, N, dtype=torch.float32, std=0.02))
    before = quant.q8_matvec.launches
    got = quant.q8_matvec(x, w["qt"], w["scale"], out_dtype=out_dtype)
    assert quant.q8_matvec.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, quant.q8_matvec_plain(x, w["qt"], w["scale"], out_dtype=out_dtype)) < 1e-2


@pytest.mark.parametrize("M", Q8_ROWS)
@pytest.mark.parametrize("K,N", [(2304, 18432), (9216, 40), (2320, 4100)])
@pytest.mark.parametrize("x_dtype,norm_dtype", [(torch.float32, torch.bfloat16),
                                                (torch.bfloat16, torch.float32)])
def test_q8_rmsnorm_matvec(M, K, N, x_dtype, norm_dtype):
    g = _gen(1)
    x = _randn(g, M, K, dtype=x_dtype)
    nw = _randn(g, K, dtype=norm_dtype, std=0.1)
    w = quant.quantize_int8(_randn(g, K, N, dtype=torch.float32, std=0.02))
    before = quant.q8_rmsnorm_matvec.launches
    got = quant.q8_rmsnorm_matvec(x, nw, w["qt"], w["scale"])
    assert quant.q8_rmsnorm_matvec.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    ref = quant.q8_rmsnorm_matvec_plain(x, nw, w["qt"], w["scale"])
    assert _rel(got, ref) < 1e-2


def _check_deterministic(M, K, N, quantize, kernels, seed):
    """Two launches of each kernel give identical bits (no atomics; the K
    split's partial sums are added in a fixed order), one count a call."""
    g = _gen(seed)
    x = _randn(g, M, K, dtype=torch.float32)
    nw = _randn(g, K, std=0.1)
    w = quantize(_randn(g, K, N, dtype=torch.float32, std=0.02))
    matvec, norm_matvec = kernels
    for kern, args in ((matvec, (x, w["qt"], w["scale"])),
                       (norm_matvec, (x, nw, w["qt"], w["scale"]))):
        before = kern.launches
        first, again = kern(*args), kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert torch.equal(first, again)


@pytest.mark.parametrize("M,K,N", [(1, 2304, 18432), (16, 9216, 2304), (5, 2320, 4100)])
def test_q8_kernels_are_deterministic(M, K, N):
    _check_deterministic(M, K, N, quant.quantize_int8,
                         (quant.q8_matvec, quant.q8_rmsnorm_matvec), 6)


@pytest.mark.parametrize("M,K,N", [(1, 2304, 18432), (16, 9216, 2304), (5, 2336, 4100),
                                   (277, 2304, 18432), (256, 4304, 1152)])
def test_q4_channel_kernels_are_deterministic(M, K, N):
    _check_deterministic(M, K, N, quant.quantize_int4,
                         (quant.q4_matvec, quant.q4_rmsnorm_matvec), 7)


def _first_launch_in_graph(quantize, kernel, K, options="", out="bfloat16", tol=1e-2, rows=16):
    """A process whose first launch of `kernel` (an RMSNorm matvec wrapper of
    ops.quant, `rows` rows; `options` for the quantize call, `out` the output
    type) is captured into a CUDA graph: at 16 rows the kernel stages x in
    chunks of at most 48 KB there (the larger shared-memory opt-in is never
    made during a capture); above, the int4 wrappers allocate their staging
    buffer inside the capture. The replay agrees with the plain version."""
    import os
    import subprocess
    import sys
    import textwrap

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import torch
        from spatialvla_tpu_torch.ops import _lib, quant
        _lib.library()
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn({rows}, {K}, generator=g, device="cuda")
        nw = (torch.randn({K}, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        w = quant.{quantize}(torch.randn({K}, 2304, generator=g, device="cuda") * 0.02{options})
        out = torch.empty({rows}, 2304, dtype=torch.{out}, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            quant.{kernel}(x, nw, w["qt"], w["scale"], out=out)
        graph.replay()
        ref = quant.{kernel}_plain(x, nw, w["qt"], w["scale"], out_dtype=torch.{out})
        rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        print(rel)
        assert rel < {tol}, rel
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_q8_first_launch_inside_a_cuda_graph():
    _first_launch_in_graph("quantize_int8", "q8_rmsnorm_matvec", 9216)


def test_q4_first_launch_inside_a_cuda_graph():
    """int4 per channel at K = 2304: all of x (72 KB at 16 rows) fits once
    the opt-in is made; inside the capture both x ranges go in 48 KB chunks
    (32, 32 and 8 packed units)."""
    _first_launch_in_graph("quantize_int4", "q4_rmsnorm_matvec", 2304)


def test_q4_grouped_first_launch_inside_a_cuda_graph():
    """int4 in 128-column groups at K = 2304, the grouped instance: inside
    the capture x is staged in chunks, and each chunk's scales are those of
    its absolute units."""
    _first_launch_in_graph("quantize_int4", "q4_rmsnorm_matvec", 2304, ", group_size=128",
                           out="float32", tol=5e-3)


@pytest.mark.parametrize("options", ["", ", group_size=128"])
def test_q4_tiled_first_launch_inside_a_cuda_graph(options):
    """The tensor-core route at 277 rows, per channel and in 128-column
    groups, first launched inside a capture (its x' staging buffer comes
    from the graph's pool)."""
    _first_launch_in_graph("quantize_int4", "q4_rmsnorm_matvec", 2304, options, out="float32",
                           tol=5e-3, rows=277)


# (K, N): the head, the down projection, SigLIP's fc2 (K/2 = 2152 bytes, not a
# multiple of 16: the tiled kernel at any M; no 128-column groups), a tiny shape
Q4_SHAPES = [(2304, 8194), (9216, 2304), (4304, 1152), (64, 40)]


def _q4_weight(g, K, N, group_size):
    return quant.quantize_int4(_randn(g, K, N, dtype=torch.float32, std=0.02),
                               group_size=group_size)


@pytest.mark.parametrize("M", [1, 5, 16, 17, 277, 512])
@pytest.mark.parametrize("K,N,group_size", [(K, N, gs) for K, N in Q4_SHAPES for gs in (None, 128)
                                            if not gs or K % min(gs, K // 2) == 0])
def test_q4_matvec(M, K, N, group_size):
    g = _gen(10)
    x = _randn(g, M, K)
    w = _q4_weight(g, K, N, group_size)
    before = quant.q4_matvec.launches
    got = quant.q4_matvec(x, w["qt"], w["scale"])
    assert quant.q4_matvec.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, quant.q4_matvec_plain(x, w["qt"], w["scale"])) < 1e-2


# per channel at M <= 16, the int4 instance of csrc/q8_matvec.cu's kernel:
# every rows instance and both of its edges; K = 9216, whose two x ranges
# are staged in chunks at 8 and 16 rows; K = 2336, 73 packed units, which
# no chunk or lane count divides; N of the head, a tiny one and one that no
# tile of channels divides; bf16 x (copied into shared memory) and fp32 x,
# each with the other type of norm weight
@pytest.mark.parametrize("M", Q8_ROWS)
@pytest.mark.parametrize("K,N,x_dtype", [(2304, 8194, torch.bfloat16), (9216, 40, torch.bfloat16),
                                         (9216, 40, torch.float32), (2336, 4100, torch.bfloat16),
                                         (2336, 4100, torch.float32)])
def test_q4_channel_rows(M, K, N, x_dtype):
    g = _gen(14)
    x = _randn(g, M, K, dtype=x_dtype)
    nw = _randn(g, K, dtype=torch.float32 if x_dtype == torch.bfloat16 else torch.bfloat16, std=0.1)
    w = _q4_weight(g, K, N, None)
    for kern, plain, args in (
            (quant.q4_matvec, quant.q4_matvec_plain, (x, w["qt"], w["scale"])),
            (quant.q4_rmsnorm_matvec, quant.q4_rmsnorm_matvec_plain, (x, nw, w["qt"], w["scale"]))):
        before = kern.launches
        got = kern(*args, out_dtype=x_dtype)
        assert kern.launches == before + 1
        assert got.dtype == x_dtype and got.shape == (M, N)
        assert _rel(got, plain(*args, out_dtype=x_dtype)) < 1e-2


def _check_q4_both(M, K, N, group_size, x_dtype, seed, route="rows", tol=5e-3):
    """q4_matvec and q4_rmsnorm_matvec on one grouped weight, x of `x_dtype`
    (the norm weight of the other type): one launch each, through `route`,
    within `tol` of the plain versions (max-rel). The outputs are fp32, so
    what differs is the summation order alone (a bf16 output may round one
    value a unit apart: up to 2^-7 of max|plain|)."""
    g = _gen(seed)
    x = _randn(g, M, K, dtype=x_dtype)
    nw = _randn(g, K, dtype=torch.float32 if x_dtype == torch.bfloat16 else torch.bfloat16, std=0.1)
    w = _q4_weight(g, K, N, group_size)
    assert w["scale"].shape == (N, K // group_size)
    assert quant.q4_route(x, w["qt"], w["scale"]) == route
    for kern, plain, args in (
            (quant.q4_matvec, quant.q4_matvec_plain, (x, w["qt"], w["scale"])),
            (quant.q4_rmsnorm_matvec, quant.q4_rmsnorm_matvec_plain, (x, nw, w["qt"], w["scale"]))):
        before = kern.launches
        got = kern(*args, out_dtype=torch.float32)
        assert kern.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (M, N)
        assert _rel(got, plain(*args, out_dtype=torch.float32)) < tol


# grouped at M <= 16, the grouped instance of csrc/q8_matvec.cu's kernel:
# every rows instance (1, 2, 4, 8, 16) and an edge (3); groups of 16, 32 and
# 128 columns (1, 2 and 8 units a group); K = 2048 (o, 16 groups of 128);
# N of the head, a tiny one and one that no tile of channels divides; bf16
# x (copied into shared memory) and fp32 x
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("group_size", [16, 32, 128])
@pytest.mark.parametrize("K,N,x_dtype", [(2304, 8194, torch.bfloat16), (2304, 40, torch.float32),
                                         (2048, 4100, torch.bfloat16), (2048, 4100, torch.float32)])
def test_q4_grouped_rows(M, group_size, K, N, x_dtype):
    _check_q4_both(M, K, N, group_size, x_dtype, 15)


# K = 9216 (down), whose two x ranges are staged in chunks at 8 and 16
# rows, so a unit's group comes from its absolute index; 48-column groups
# (3 units a group: a division, not a shift), also at K = 2304 and one row
@pytest.mark.parametrize("M,K", [(8, 9216), (16, 9216), (1, 2304), (16, 2304)])
@pytest.mark.parametrize("group_size", [16, 48, 128])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_q4_grouped_chunked_k(M, K, group_size, x_dtype):
    _check_q4_both(M, K, 2304 if M == 16 else 100, group_size, x_dtype, 16)


# the other routes: groups of 8 and 24 columns (not a multiple of 16) take
# q4_small_kernel at M <= 16 and the FMA tiles above; a misaligned x takes
# the tensor-core kernel, or the FMA tiles in groups of 24 columns
@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("K,N,group_size", [(2304, 4096, 8), (2304, 4096, 24), (96, 40, 24)])
def test_q4_other_group_widths_take_the_small_kernel(M, K, N, group_size):
    _check_q4_both(M, K, N, group_size, torch.float32, 17, route="small")


@pytest.mark.parametrize("M", [17, 277])
@pytest.mark.parametrize("K,N,group_size", [(2304, 4096, 8), (2304, 4096, 24), (96, 40, 24)])
def test_q4_other_group_widths_take_the_fma_tiles(M, K, N, group_size):
    _check_q4_both(M, K, N, group_size, torch.float32, 19, route="tiled_fma")


@pytest.mark.parametrize("group_size,route", [(None, "tiled"), (128, "tiled"), (24, "tiled_fma")])
def test_q4_misaligned_x_takes_the_tiled_kernel(group_size, route):
    g = _gen(18)
    K, N = 2304, 4096
    x = _randn(g, 4 * K + 1)[1:].view(4, K)  # contiguous, 2 bytes past 16-byte alignment
    w = _q4_weight(g, K, N, group_size)
    assert quant.q4_route(x, w["qt"], w["scale"]) == route
    got = quant.q4_matvec(x, w["qt"], w["scale"], out_dtype=torch.float32)
    assert _rel(got, quant.q4_matvec_plain(x, w["qt"], w["scale"], out_dtype=torch.float32)) < 5e-3


# the tensor-core route (M > 16, per channel or in groups of a multiple of 16
# columns): rows of one m16 fragment past a tile (17), of a ragged tile (31,
# 255, 277: 21 rows in the last 64-row tile), whole tiles (64, 256, 512);
# the prefill's qkv, gate|up and down, SigLIP's fc2 (K/2 = 2152 bytes, 8-byte
# loads) and a ragged shape (K/2 = 1160, N = 4100); both wrappers, bf16 x
# and out and fp32 x and out (fp32 out within 5e-3 of plain: the summation
# order alone; bf16 out one rounding more)
Q4_TILED_SHAPES = [(2304, 4096), (2304, 18432), (9216, 2304), (4304, 1152), (2320, 4100)]


@pytest.mark.parametrize("M", [17, 31, 64, 255, 256, 277, 512])
@pytest.mark.parametrize("K,N,group_size", [(K, N, gs) for K, N in Q4_TILED_SHAPES
                                            for gs in (None, 16, 32, 128)
                                            if not gs or (K // 2) % gs == 0])
def test_q4_tiled(M, K, N, group_size):
    g = _gen(20)
    w = _q4_weight(g, K, N, group_size)
    nw = _randn(g, K, std=0.1)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 5e-3)):
        x = _randn(g, M, K, dtype=dtype)
        assert quant.q4_route(x, w["qt"], w["scale"]) == "tiled"
        for kern, plain, args in (
                (quant.q4_matvec, quant.q4_matvec_plain, (x, w["qt"], w["scale"])),
                (quant.q4_rmsnorm_matvec, quant.q4_rmsnorm_matvec_plain,
                 (x, nw, w["qt"], w["scale"]))):
            before = kern.launches
            got = kern(*args, out_dtype=dtype)
            assert kern.launches == before + 1
            assert got.dtype == dtype and got.shape == (M, N)
            assert _rel(got, plain(*args, out_dtype=dtype)) < tol


# misaligned views on the tensor-core route: x 2 or 4 bytes past 16-byte
# alignment, qt 1 byte (byte loads) or 8 bytes (8-byte loads) past it
@pytest.mark.parametrize("M", [4, 277])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qt_offset", [0, 1, 8])
@pytest.mark.parametrize("group_size", [None, 128])
def test_q4_tiled_misaligned_views(M, x_dtype, qt_offset, group_size):
    g = _gen(21)
    K, N = 2304, 4096
    x = _randn(g, M * K + 1, dtype=x_dtype)[1:].view(M, K)
    nw = _randn(g, K, std=0.1)
    w = _q4_weight(g, K, N, group_size)
    flat = torch.empty(N * K // 2 + qt_offset, dtype=torch.uint8, device=DEV)
    qt = flat[qt_offset:].view(N, K // 2)
    qt.copy_(w["qt"])
    assert quant.q4_route(x, qt, w["scale"]) == "tiled"
    for kern, plain, args in ((quant.q4_matvec, quant.q4_matvec_plain, (x, qt, w["scale"])),
                              (quant.q4_rmsnorm_matvec, quant.q4_rmsnorm_matvec_plain,
                               (x, nw, qt, w["scale"]))):
        got = kern(*args, out_dtype=torch.float32)
        assert _rel(got, plain(*args, out_dtype=torch.float32)) < 5e-3


@pytest.mark.parametrize("M,K,N", [(1, 2304, 18432), (16, 9216, 2304), (5, 2048, 4100),
                                   (277, 2304, 18432), (277, 9216, 2304)])
def test_q4_grouped_kernels_are_deterministic(M, K, N):
    _check_deterministic(M, K, N, lambda w: quant.quantize_int4(w, group_size=128),
                         (quant.q4_matvec, quant.q4_rmsnorm_matvec), 8)


@pytest.mark.parametrize("M", [1, 16, 277])
@pytest.mark.parametrize("N", [4096, 18432])
@pytest.mark.parametrize("group_size", [None, 128])
def test_q4_rmsnorm_matvec(M, N, group_size):
    g = _gen(11)
    K = 2304
    x = _randn(g, M, K, dtype=torch.float32)
    nw = _randn(g, K, std=0.1)
    w = _q4_weight(g, K, N, group_size)
    got = quant.q4_rmsnorm_matvec(x, nw, w["qt"], w["scale"], out_dtype=torch.float32)
    ref = quant.q4_rmsnorm_matvec_plain(x, nw, w["qt"], w["scale"], out_dtype=torch.float32)
    assert _rel(got, ref) < 1e-2


# groups of any width quantize_int4 makes: narrower than a 16-code chunk (1,
# 8), crossing chunk and 32-byte step boundaries (24, 48), and SigLIP's fc2
# (K/2 = 2152 bytes) in 8-column groups on the tiled kernel
@pytest.mark.parametrize("M", [1, 16, 277])
@pytest.mark.parametrize("K,N,group_size", [(64, 40, 1), (64, 40, 8), (96, 40, 24),
                                            (2304, 4096, 16), (2304, 4096, 24),
                                            (2304, 4096, 48), (4304, 1152, 8)])
def test_q4_any_group_width(M, K, N, group_size):
    g = _gen(13)
    w = _q4_weight(g, K, N, group_size)
    assert w["scale"].shape == (N, K // group_size)
    x = _randn(g, M, K, dtype=torch.float32)
    nw = _randn(g, K, std=0.1)
    got = quant.q4_matvec(x, w["qt"], w["scale"], out_dtype=torch.float32)
    ref = quant.q4_matvec_plain(x, w["qt"], w["scale"], out_dtype=torch.float32)
    assert _rel(got, ref) < 1e-3
    got = quant.q4_rmsnorm_matvec(x, nw, w["qt"], w["scale"], out_dtype=torch.float32)
    ref = quant.q4_rmsnorm_matvec_plain(x, nw, w["qt"], w["scale"], out_dtype=torch.float32)
    assert _rel(got, ref) < 1e-3


def test_q4_rejects_unsupported_groups():
    """A scale of G groups must tile both halves of K (an even G dividing K):
    any other (N, G) is not a quantize_int4 format."""
    g = _gen(12)
    w = _q4_weight(g, 64, 40, 16)
    x = _randn(g, 1, 64)
    for scale in (w["scale"][:, :3].contiguous(), w["scale"][:, :1].contiguous(),
                  torch.ones(40, 6, device=DEV)):  # G = 3, 1, 6 (6 does not divide 64)
        with pytest.raises(ValueError, match="whole groups"):
            quant.q4_matvec(x, w["qt"], scale)


def test_action_head_slice_is_a_view():
    """The action block of the int8 head goes to the kernel without a copy."""
    g = _gen(2)
    w = quant.quantize_int8(_randn(g, 256, 1000, dtype=torch.float32, std=0.02))
    head = sv._slice_head({"lm_head": w}, 300, 600)
    assert head["qt"].data_ptr() == w["qt"].data_ptr() + 300 * 256
    x = _randn(g, 1, 256)
    got = quant.qmatmul(x, head)
    assert _rel(got, quant.q8_matvec_plain(x, head["qt"], head["scale"])) < 1e-2


# (M, S, positions, D, Nq, Nkv): the serving path's shapes (batch 1, the
# padded batch of 2, the 16-row matrix), an empty / one-slot / full cache,
# positions on chunk boundaries (attention_chunk: 32 slots at (2, 96), 64 at
# 16 rows and S = 332 or at S = 4096, 512 at 16 rows and S = 4096), an S
# that is not a multiple of the chunk, 16 rows at spread positions, the
# longest cache the step allows (its sliding window), the tiny configs'
# head_dim, and 1, 4 and 8 query heads per kv head (the kernel's
# register-array instances)
ATTN_CASES = [
    (1, 278, [270], 256, 8, 4),
    (2, 278, [266, 259], 256, 8, 4),
    (3, 64, [0, 1, 64], 256, 8, 4),
    (16, 332, list(range(300, 316)), 256, 8, 4),
    (2, 96, [32, 64], 256, 8, 4),
    (2, 100, [0, 100], 256, 8, 4),
    (16, 332, [0, 1, 31, 32, 33, 63, 64, 65, 100, 127, 128, 200, 255, 256, 300, 332], 256, 8, 4),
    (1, 4096, [4000], 256, 8, 4),
    (2, 4096, [4096, 33], 256, 8, 4),
    (16, 4096, [0, 1, 511, 512, 513, 1024, 2047, 2048, 3000, 3583, 3584, 3585, 4000, 4095, 4096,
                64], 256, 8, 4),
    (3, 50, [0, 17, 50], 32, 4, 2),
    (2, 200, [150, 7], 128, 4, 4),
    (2, 200, [150, 7], 64, 16, 4),
    (1, 278, [270], 256, 8, 1),
]


def _check_attention_kernel(kern, M, S, positions, D, Nq, Nkv, kv8, seed):
    """The kernel against decode_attention_plain; one launch a call; two
    launches on one scratch (whose tickets each launch leaves zero) and one
    on a scratch the wrapper allocates give bit-identical outputs."""
    g = _gen(seed)
    qkv = _randn(g, M, (Nq + 2 * Nkv) * D)
    ck, cv = _randn(g, M, Nkv, S, D, std=0.3), _randn(g, M, Nkv, S, D, std=0.3)
    extra = {}
    if kv8:
        (ck, ks), (cv, vs) = quant.quantize_kv(ck), quant.quantize_kv(cv)
        flat = lambda sc: sc.permute(1, 0, 2).reshape(Nkv, 1, M * S).contiguous()  # noqa: E731
        extra = dict(ks=flat(ks), vs=flat(vs))
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    cos, sin = ds.rope_tables(pos + 1, D, 10000.0)

    def run(fn, **kw):
        bufs = dict(attn_out=torch.empty(M, Nq * D, dtype=torch.bfloat16, device=DEV),
                    k_new=torch.empty(M, Nkv, D, dtype=torch.bfloat16, device=DEV),
                    v_new=torch.empty(M, Nkv, D, dtype=torch.bfloat16, device=DEV))
        fn(qkv, cos, sin, ck, cv, pos, num_heads=Nq, q_scale=D ** -0.5, cap=50.0, **extra, **kw,
           **bufs)
        return bufs

    scratch = ds.attention_scratch(M, Nkv, S, D, Nq, DEV)
    before = kern.launches
    first = run(kern, scratch=scratch)
    assert kern.launches == before + 1
    again = [run(kern, scratch=scratch), run(kern)]
    assert kern.launches == before + 3
    plain = run(ds.decode_attention_plain)
    torch.cuda.synchronize()
    for other in again:
        for k in first:
            assert torch.equal(first[k], other[k]), k
    assert _rel(first["attn_out"], plain["attn_out"]) < 1e-2
    assert _rel(first["k_new"], plain["k_new"]) < 1e-2
    assert torch.equal(first["v_new"], plain["v_new"])


@pytest.mark.parametrize("M,S,positions,D,Nq,Nkv", ATTN_CASES)
def test_decode_attention(M, S, positions, D, Nq, Nkv):
    _check_attention_kernel(ds.decode_attention, M, S, positions, D, Nq, Nkv, False, 3)


@pytest.mark.parametrize("M,S,positions,D,Nq,Nkv", ATTN_CASES)
def test_decode_attention_kv8(M, S, positions, D, Nq, Nkv):
    _check_attention_kernel(ds.decode_attention_kv8, M, S, positions, D, Nq, Nkv, True, 13)


def test_decode_attention_rejects_unsupported_head_dim():
    M, Nq, Nkv, D, S = 1, 4, 2, 16, 8
    z = lambda *s: torch.zeros(s, dtype=torch.bfloat16, device=DEV)  # noqa: E731
    cos = torch.zeros(M, D, device=DEV)
    with pytest.raises(ValueError, match="multiple of 32"):
        ds.decode_attention(z(M, (Nq + 2 * Nkv) * D), cos, cos, z(M, Nkv, S, D), z(M, Nkv, S, D),
                            torch.zeros(M, dtype=torch.int32, device=DEV), num_heads=Nq,
                            q_scale=1.0, cap=50.0, attn_out=z(M, Nq * D), k_new=z(M, Nkv, D),
                            v_new=z(M, Nkv, D))


@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("final", [False, True])
def test_norm_residual_and_gelu_mul(M, final):
    g = _gen(4)
    H, I = 2304, 9216
    h0, upd = _randn(g, M, H, dtype=torch.float32), _randn(g, M, H)
    w, fw = _randn(g, H, std=0.1), _randn(g, H, std=0.1)
    res = []
    for fn in (ds.norm_residual, ds.norm_residual_plain):
        h = h0.clone()
        out = torch.zeros(M, H, dtype=torch.bfloat16, device=DEV)
        fn(h, upd, w, eps=1e-6, final_w=fw if final else None, final_out=out if final else None)
        res.append((h, out))
    assert _rel(res[0][0], res[1][0]) < 1e-2
    if final:
        assert _rel(res[0][1], res[1][1]) < 1e-2

    gu = _randn(g, M, 2 * I)
    ka, pa = (torch.empty(M, I, dtype=torch.bfloat16, device=DEV) for _ in range(2))
    ds.gelu_mul(gu, out=ka)
    ds.gelu_mul_plain(gu, out=pa)
    assert _rel(ka, pa) < 1e-2


# Gemma2's widths (2B, 9B, 27B): one row in registers, 288, 448 and 576
# threads; rows of one block each; f32 and bf16 norm weights
@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("H", [2304, 3584, 4608])
@pytest.mark.parametrize("final", [False, True])
def test_norm_residual_in_registers(M, H, final):
    """The one-round norm_residual against norm_residual_plain: h within
    1e-2 of max|plain| (a bf16 rounding may fall a unit apart where the fp32
    sums of squares differ in order), the normed output within 1e-2; two
    launches give identical bits; one count a launch."""
    g = _gen(40 + M)
    h0, upd = _randn(g, M, H, dtype=torch.float32, std=8.0), _randn(g, M, H)
    w = _randn(g, H, dtype=torch.float32 if M % 2 else torch.bfloat16, std=0.1)
    fw = _randn(g, H, std=0.1) if final else None
    res = []
    for fn in (ds.norm_residual, ds.norm_residual, ds.norm_residual_plain):
        h = h0.clone()
        out = torch.full((M, H), float("nan"), dtype=torch.bfloat16, device=DEV) if final else None
        before = ds.norm_residual.launches
        fn(h, upd, w, eps=1e-6, final_w=fw, final_out=out)
        torch.cuda.synchronize()
        assert ds.norm_residual.launches == before + (fn is ds.norm_residual)
        res.append((h, out))
    (hk, ok), (hk2, ok2), (hp, op) = res
    assert torch.equal(hk, hk2) and _rel(hk, hp) < 1e-2
    if final:
        assert torch.equal(ok, ok2) and _rel(ok, op) < 1e-2


def test_norm_residual_refuses_other_widths():
    """H not a multiple of 8, H above 8192 (a row no longer fits the
    registers of one block) and operands off 16-byte alignment raise; none
    falls back to the plain version."""
    g = _gen(47)
    for H in (2300, 8200):
        h, upd, w = _randn(g, 1, H, dtype=torch.float32), _randn(g, 1, H), _randn(g, H)
        with pytest.raises(ValueError, match="multiple of 8"):
            ds.norm_residual(h, upd, w, eps=1e-6)
    big = _randn(g, 2 * 2304 + 4, dtype=torch.float32)
    h = big[4:].reshape(2, 2304)  # 16 bytes off: aligned; 4 floats in
    h_off = big[2:2 + 2 * 2304].reshape(2, 2304)  # 8 bytes off
    upd, w = _randn(g, 2, 2304), _randn(g, 2304)
    ds.norm_residual(h, upd, w, eps=1e-6)
    with pytest.raises(ValueError, match="16-byte"):
        ds.norm_residual(h_off, upd, w, eps=1e-6)


GELU_FORMATS = {"int8": (quant.quantize_int8, {}), "int4": (quant.quantize_int4, {}),
                "int4-g128": (quant.quantize_int4, dict(group_size=128))}
# every rows instance of the gelu epilogue: the plain matvec at 1, 2, 4, 8
# and 16 rows (and 5, an edge), the residual variant at 1, 2 and 4 (the most
# it takes); gate|up of the flagship (2304 -> 2 x 9216) and an odd I (2051)
GELU_CASES = ([("plain", M) for M in (1, 2, 4, 5, 8, 16)]
              + [("residual", M) for M in (1, 2, 4)])


@pytest.mark.parametrize("kind,M", GELU_CASES)
@pytest.mark.parametrize("fmt", list(GELU_FORMATS))
@pytest.mark.parametrize("I", [9216, 2051])
def test_gelu_epilogue_is_the_pair(kind, M, fmt, I):
    """The gate|up matvec with gelu(gate) * up in its epilogue (gelu=True)
    gives the bits of the same kernel's bf16 gate|up followed by the
    gelu_mul kernel (each channel's sum keeps its order), and holds to the
    plain version (matvec_plain then gelu_mul_plain) within 1e-2 of
    max|plain|; one launch, counted in launches and gelu_launches; h_out as
    without the epilogue."""
    g = _gen(50 + M)
    K = 2304
    quantize, kw = GELU_FORMATS[fmt]
    w = quantize(_randn(g, K, 2 * I, dtype=torch.float32, std=0.02), **kw)
    qt, scale = w["qt"], w["scale"]
    if kind == "plain":
        x = _randn(g, M, K)
        assert quant.gelu_route(x, qt, scale)
        kern = quant.q4_matvec if fmt != "int8" else quant.q8_matvec
        call = lambda gelu, out=None: quant.matvec(x, qt, scale, gelu=gelu, out=out)  # noqa: E731
        plain = lambda: quant.matvec_plain(x, qt, scale, gelu=True)  # noqa: E731
    else:
        h_in, upd = _randn(g, M, K, dtype=torch.float32, std=8.0), _randn(g, M, K)
        post, norm = _randn(g, K, std=0.1), _randn(g, K, std=0.1)
        assert quant.residual_route(h_in, qt, scale) and quant.gelu_route(h_in, qt, scale)
        kern = (quant.q4_residual_rmsnorm_matvec if fmt != "int8"
                else quant.q8_residual_rmsnorm_matvec)
        h_outs = [torch.empty_like(h_in) for _ in range(3)]
        call = lambda gelu, out=None: quant.residual_rmsnorm_matvec(  # noqa: E731
            h_in, upd, post, norm, qt, scale, h_out=h_outs[int(gelu)], gelu=gelu, out=out)
        plain = lambda: quant.residual_rmsnorm_matvec_plain(  # noqa: E731
            h_in, upd, post, norm, qt, scale, h_out=h_outs[2], gelu=True)
    before = (kern.launches, kern.gelu_launches)
    act = call(True, torch.full((M, I), float("nan"), dtype=torch.bfloat16, device=DEV))
    torch.cuda.synchronize()
    assert (kern.launches, kern.gelu_launches) == (before[0] + 1, before[1] + 1)
    gu = call(False)
    pair = torch.empty(M, I, dtype=torch.bfloat16, device=DEV)
    ds.gelu_mul(gu, out=pair)
    ref = plain()
    assert act.shape == (M, I) and act.dtype == torch.bfloat16
    assert torch.equal(act, pair)
    assert torch.equal(call(True), act)
    assert _rel(act, ref) < 1e-2
    if kind == "residual":
        assert torch.equal(h_outs[0], h_outs[1]) and _rel(h_outs[1], h_outs[2]) < 1e-2


def test_gelu_epilogue_refuses_other_routes():
    """gelu=True on operands that the few-row kernel does not take (int4 in
    24-column groups, more than 16 rows, misaligned x) or with an odd N or a
    non-bf16 output raises before any launch; gelu_route says so first."""
    g = _gen(56)
    K = 2304
    w24 = quant.quantize_int4(_randn(g, K, 512, dtype=torch.float32, std=0.02), group_size=24)
    w8 = quant.quantize_int8(_randn(g, K, 512, dtype=torch.float32, std=0.02))
    w4 = quant.quantize_int4(_randn(g, K, 512, dtype=torch.float32, std=0.02))
    x = _randn(g, 1, K)
    big = _randn(g, 17, K)
    x_off = _randn(g, K + 1)[1:].reshape(1, K)
    for xx, ww in ((x, w24), (big, w4), (x_off, w4)):
        assert not quant.gelu_route(xx, ww["qt"], ww["scale"])
        with pytest.raises(ValueError, match="gelu"):
            quant.matvec(xx, ww["qt"], ww["scale"], gelu=True)
    assert not quant.gelu_route(x_off, w8["qt"], w8["scale"])
    w_odd = quant.quantize_int8(_randn(g, K, 513, dtype=torch.float32, std=0.02))
    assert not quant.gelu_route(x, w_odd["qt"], w_odd["scale"])
    with pytest.raises(ValueError, match="gelu"):
        quant.matvec(x, w_odd["qt"], w_odd["scale"], gelu=True)
    with pytest.raises(ValueError, match="gelu"):
        quant.matvec(x, w8["qt"], w8["scale"], gelu=True, out_dtype=torch.float32)


FORMATS = {"int8": dict(bits=8), "int4": dict(bits=4), "int4-g128": dict(bits=4, group_size=128),
           "int8+mlp4": dict(bits=8, mlp_bits=4)}


@pytest.mark.parametrize("M,S", [(1, 32), (3, 48)])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("kv8", [False, True], ids=["bf16kv", "kv8"])
def test_fused_decode_step(M, S, fmt, kv8):
    """Two layers at the flagship's width, per-row positions, every weight
    and cache format."""
    g = _gen(5)
    cfg = Gemma2Config(vocab_size=512, hidden_size=2304, intermediate_size=9216, num_layers=2,
                       num_heads=8, num_kv_heads=4, head_dim=256, sliding_window=4096,
                       query_pre_attn_scalar=256.0)
    with torch.inference_mode():
        lm = gemma2.init_params(cfg, generator=g, device=DEV, dtype=torch.bfloat16)
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            lm["layers"][k] = _randn(g, 2, 2304, std=0.1)
        lm = quant.quantize_lm_params(lm, **FORMATS[fmt])
        x = _randn(g, M, 2304, std=0.3 * 2304 ** 0.5)
        ck, cv = _randn(g, 2, M, 4, S, 256, std=0.3), _randn(g, 2, M, 4, S, 256, std=0.3)
        kw = {}
        if kv8:
            ck, ks = quant.quantize_kv(ck)
            cv, vs = quant.quantize_kv(cv)
            kw = dict(cache_k_scale=ks, cache_v_scale=vs)
        pos = torch.arange(S - M, S, dtype=torch.int32, device=DEV)
        got = ds.fused_decode_step(lm, cfg, x, ck, cv, pos, pos + 1, **kw)
        ref = ds.fused_decode_step_plain(lm, cfg, x, ck, cv, pos, pos + 1, **kw)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel(a, b) < 0.02


QUANTIZE = {
    "int8": (dict(bits=8), (quant.q8_matvec, quant.q8_rmsnorm_matvec, ds.decode_attention)),
    "int4": (dict(bits=4), (quant.q4_matvec, quant.q4_rmsnorm_matvec, ds.decode_attention)),
    "int8+mlp4+kv8": (dict(bits=8, mlp_bits=4, kv_bits=8),
                      (quant.q8_matvec, quant.q4_matvec, quant.q8_rmsnorm_matvec,
                       quant.q4_rmsnorm_matvec, ds.decode_attention_kv8)),
}


@pytest.mark.parametrize("fmt", list(QUANTIZE))
def test_tiny_predict_goes_through_the_kernels(fmt):
    """The serving entry point on the card: the fused decode path launches
    the kernels of the tree's formats, and its greedy ids follow the unfused
    path's (first token equal; equal up to the first step whose margin is
    below 0.5); with kv_bits=8 the reference is the bf16 cache."""
    cfg = spatialvla_tiny(use_vision_zoe=True)
    # head_dim 32 for the attention kernel; a window that holds the whole cache
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, head_dim=32, query_pre_attn_scalar=32.0, sliding_window=512))
    qkw, kernels = QUANTIZE[fmt]
    policy = SpatialVLAPolicy.init_random(cfg, DEV, seed=0).quantize(**qkw)
    size = cfg.vision.image_size
    frame = (np.random.RandomState(0).rand(size, size, 3) * 255).astype(np.uint8)
    # gate|up (hidden 48): an int8 MLP takes the residual kernel with
    # gelu(gate) * up in its epilogue; an int4 one (K / 2 = 24, not the
    # few-row kernel's) writes gate | up and launches gelu_mul
    int8_mlp = qkw.get("mlp_bits", qkw["bits"]) == 8
    counters = [(c, "launches") for c in kernels + (ds.norm_residual,)] + (
        [(quant.q8_residual_rmsnorm_matvec, "gelu_launches")] if int8_mlp
        else [(ds.gelu_mul, "launches")])
    before = [getattr(*c) for c in counters]
    gelu_mul_before = ds.gelu_mul.launches
    out = policy.predict(frame, "pick up the cup", return_margins=True)
    assert all(getattr(*c) > b for c, b in zip(counters, before))
    assert (ds.gelu_mul.launches == gelu_mul_before) == int8_mlp
    assert out["actions"].shape == (4, 7) and np.isfinite(out["actions"]).all()

    inputs = policy.processor(frame, "pick up the cup")
    with torch.inference_mode():
        ref, margins = sv.predict_action(
            policy.params, cfg, torch.as_tensor(inputs["input_ids"], dtype=torch.long, device=DEV),
            pixel_values=torch.as_tensor(inputs["pixel_values"], device=DEV),
            intrinsic=torch.as_tensor(inputs["intrinsic"], device=DEV),
            use_fused_decode=False, return_margins=True)
    ids, ref, margins = out["action_ids"], ref[0].cpu().numpy(), margins[0].cpu().numpy()
    assert ids[0] == ref[0]
    for t in range(1, len(ids)):
        if margins[t] < 0.5:
            break
        assert ids[t] == ref[t]


# ---------------------------------------------------------------------------
# the residual kernels: norm_residual folded into the next RMSNorm matvec
# ---------------------------------------------------------------------------

RESID_FORMATS = {"int8": (quant.quantize_int8, {}), "int4": (quant.quantize_int4, {}),
                 "int4-g128": (quant.quantize_int4, dict(group_size=128))}


def _resid_case(g, M, K, N, fmt, post_dtype=torch.bfloat16):
    quantize, kw = RESID_FORMATS[fmt]
    h_in = _randn(g, M, K, dtype=torch.float32, std=8.0)
    upd = _randn(g, M, K)
    post, norm = _randn(g, K, dtype=post_dtype, std=0.1), _randn(g, K, std=0.1)
    w = quantize(_randn(g, K, N, dtype=torch.float32, std=0.02), **kw)
    return h_in, upd, post, norm, w


# every rows instance of the residual variant (1, 2, 4) and an edge (3);
# qkv (2304 -> 4096) and gate|up (2304 -> 18432), and the largest K it takes
# (4096, all of it staged at 4 rows within 48 KB); the int4 one-row instance
# shares one round of loads between its passes; bf16 and fp32 outputs
@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("fmt", list(RESID_FORMATS))
@pytest.mark.parametrize("K,N,out_dtype", [(2304, 4096, torch.bfloat16),
                                           (2304, 18432, torch.float32),
                                           (4096, 256, torch.float32)])
def test_residual_rmsnorm_matvec(M, fmt, K, N, out_dtype):
    """h_out within 1e-2 of the plain version's (max-rel; a bf16 rounding
    may fall a unit apart where the fp32 sums of the RMS differ in order),
    the output within 1e-2 (bf16 out) / 5e-3 (fp32 out) of plain; one count a
    call; two launches give identical bits; h_in is left as it was."""
    g = _gen(30)
    h_in, upd, post, norm, w = _resid_case(g, M, K, N, fmt, torch.float32 if M % 2 else torch.bfloat16)
    keep = h_in.clone()
    kern = quant.q4_residual_rmsnorm_matvec if fmt != "int8" else quant.q8_residual_rmsnorm_matvec
    assert quant.residual_route(h_in, w["qt"], w["scale"])
    outs = []
    for _ in range(2):
        h_out = torch.full_like(h_in, float("nan"))
        before = kern.launches
        got = quant.residual_rmsnorm_matvec(h_in, upd, post, norm, w["qt"], w["scale"], h_out=h_out,
                                            out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        outs.append((h_out, got))
    h_ref = torch.empty_like(h_in)
    ref = quant.residual_rmsnorm_matvec_plain(h_in, upd, post, norm, w["qt"], w["scale"],
                                              h_out=h_ref, out_dtype=out_dtype)
    (h_out, got), (h_again, again) = outs
    assert torch.equal(h_in, keep)
    assert torch.equal(h_out, h_again) and torch.equal(got, again)
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(h_out, h_ref) < 1e-2
    assert _rel(got, ref) < (1e-2 if out_dtype == torch.bfloat16 else 5e-3)


def test_residual_rmsnorm_matvec_refuses_aliasing_and_other_routes():
    """h_out may not overlap h_in (other blocks still read it); int4 in
    24-column groups, more than 4 rows (int8 and int4) or K above 4096 is
    not the kernel's (residual_route) and raises."""
    g = _gen(31)
    h_in, upd, post, norm, w = _resid_case(g, 2, 2304, 512, "int8")
    with pytest.raises(ValueError, match="overlaps"):
        quant.residual_rmsnorm_matvec(h_in, upd, post, norm, w["qt"], w["scale"], h_out=h_in)
    big = torch.empty(3, 2304, dtype=torch.float32, device=DEV)
    with pytest.raises(ValueError, match="overlaps"):
        quant.residual_rmsnorm_matvec(big[:2], upd, post, norm, w["qt"], w["scale"], h_out=big[1:])
    w24 = quant.quantize_int4(_randn(g, 2304, 512, dtype=torch.float32, std=0.02), group_size=24)
    assert not quant.residual_route(h_in, w24["qt"], w24["scale"])
    with pytest.raises(ValueError, match="residual_route"):
        quant.q4_residual_rmsnorm_matvec(h_in, upd, post, norm, w24["qt"], w24["scale"],
                                         h_out=torch.empty_like(h_in))
    w4 = quant.quantize_int4(_randn(g, 2304, 512, dtype=torch.float32, std=0.02))
    for M in (5, 8, 16):
        hM = _randn(g, M, 2304, dtype=torch.float32)
        for ww in (w, w4):
            assert not quant.residual_route(hM, ww["qt"], ww["scale"])
            with pytest.raises(ValueError, match="residual_route"):
                quant.residual_rmsnorm_matvec(hM, _randn(g, M, 2304), post, norm, ww["qt"],
                                              ww["scale"], h_out=torch.empty_like(hM))
    h_big, up_big, p_big, n_big, w_big = _resid_case(g, 1, 4608, 256, "int8")
    with pytest.raises(ValueError, match="residual_route"):
        quant.residual_rmsnorm_matvec(h_big, up_big, p_big, n_big, w_big["qt"], w_big["scale"],
                                      h_out=torch.empty_like(h_big))


@pytest.mark.parametrize("fmt", list(RESID_FORMATS))
def test_residual_first_launch_inside_a_cuda_graph(fmt):
    """A process whose first launch of the residual kernel is captured into
    a CUDA graph, at 4 rows of K = 2304: the larger shared-memory opt-in is
    not made inside the capture, and all of h' fits the first 48 KB. The
    replay agrees with the plain version, and writes h_out."""
    import os
    import subprocess
    import sys
    import textwrap

    quantize, kw = RESID_FORMATS[fmt]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import torch
        from spatialvla_tpu_torch.ops import _lib, quant
        _lib.library()
        g = torch.Generator(device="cuda").manual_seed(0)
        M, K = 4, 2304
        h_in = torch.randn(M, K, generator=g, device="cuda") * 8
        upd = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        post, nw = ((torch.randn(K, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
                    for _ in range(2))
        w = quant.{quantize.__name__}(torch.randn(K, 4096, generator=g, device="cuda") * 0.02,
                                      **{kw!r})
        h_out = torch.zeros_like(h_in)
        out = torch.empty(M, 4096, dtype=torch.float32, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            quant.residual_rmsnorm_matvec(h_in, upd, post, nw, w["qt"], w["scale"], h_out=h_out,
                                          out=out)
        graph.replay()
        h_ref = torch.empty_like(h_in)
        ref = quant.residual_rmsnorm_matvec_plain(h_in, upd, post, nw, w["qt"], w["scale"],
                                                  h_out=h_ref, out_dtype=torch.float32)
        rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
        print(rel(out, ref), rel(h_out, h_ref))
        assert rel(out, ref) < 5e-3 and rel(h_out, h_ref) < 1e-2
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_step_takes_the_unfused_pair_for_24_column_groups():
    """A tree in 24-column groups (not a multiple of 16) is not the residual
    kernels': its step runs norm_residual, writing the next norm's x', +
    q4_matvec twice a layer (2 L norm_residual launches with the final one,
    one RMSNorm matvec: layer 0's qkv), and gate|up then gelu_mul (L
    launches); an int8 tree's step the residual kernel 2 L - 1 times,
    norm_residual once and gelu(gate) * up in gate|up's epilogue; both hold
    to the plain step within 0.02."""
    g = _gen(32)
    # 6 query heads of 256 (o's K = 1536, whose halves hold whole 24-column
    # groups, as the flagship's 2048 do not)
    cfg = Gemma2Config(vocab_size=512, hidden_size=2304, intermediate_size=9216, num_layers=2,
                       num_heads=6, num_kv_heads=3, head_dim=256, sliding_window=4096,
                       query_pre_attn_scalar=256.0)
    L, M, S = 2, 1, 32
    with torch.inference_mode():
        base = gemma2.init_params(cfg, generator=g, device=DEV, dtype=torch.bfloat16)
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            base["layers"][k] = _randn(g, 2, 2304, std=0.1)
        x = _randn(g, M, 2304, std=0.3 * 2304 ** 0.5)
        ck, cv = _randn(g, 2, M, 3, S, 256, std=0.3), _randn(g, 2, M, 3, S, 256, std=0.3)
        pos = torch.full((M,), S - 1, dtype=torch.int32, device=DEV)
        for qkw, resid, fused in ((dict(bits=4, group_size=24), quant.q4_residual_rmsnorm_matvec,
                                   False),
                                  (dict(bits=8), quant.q8_residual_rmsnorm_matvec, True)):
            lm = quant.quantize_lm_params(base, **qkw)
            norm = quant.q4_rmsnorm_matvec if qkw["bits"] == 4 else quant.q8_rmsnorm_matvec
            counts = (resid, ds.norm_residual, norm, ds.gelu_mul)
            before = [c.launches for c in counts]
            got = ds.fused_decode_step(lm, cfg, x, ck, cv, pos, pos + 1)
            ref = ds.fused_decode_step_plain(lm, cfg, x, ck, cv, pos, pos + 1)
            n = [c.launches - b for c, b in zip(counts, before)]
            assert n == ([2 * L - 1, 1, 1, 0] if fused else [0, 2 * L, 1, L]), (qkw, n)
            for a, b in zip(got, ref):
                assert _rel(a, b) < 0.02


def _tiny_policy(qkw):
    cfg = spatialvla_tiny(use_vision_zoe=True)
    # head_dim 32 for the attention kernel; a window that holds the whole
    # cache; hidden 64 so that int4 (K / 2 = 32) takes the residual kernels
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, head_dim=32, query_pre_attn_scalar=32.0, sliding_window=512, hidden_size=64))
    return cfg, SpatialVLAPolicy.init_random(cfg, DEV, seed=0).quantize(**qkw)


@pytest.mark.parametrize("fmt", list(QUANTIZE))
def test_graph_loop_matches_the_eager_loop(fmt):
    """The decode loop replayed as a CUDA graph gives the eager loop's ids
    and margins, for a request and a right-padded 2-row batch; the graph is
    captured once per shape and replayed after, also for a request with
    another prefix length in the same 64-slot cache bucket; every replay
    credits the wrappers' launch counts with what one eager request
    launches; quantize drops the graphs."""
    qkw, kernels = QUANTIZE[fmt]
    cfg, policy = _tiny_policy(qkw)
    size = cfg.vision.image_size
    frames = [(np.random.RandomState(i).rand(size, size, 3) * 255).astype(np.uint8)
              for i in range(2)]
    texts = ["pick up the cup", "open the top drawer of the desk"]
    counters = kernels + (ds.norm_residual, ds.gelu_mul, quant.q8_residual_rmsnorm_matvec,
                          quant.q4_residual_rmsnorm_matvec)

    def run(graph, fn):
        policy.use_cuda_graph = graph
        before = [c.launches for c in counters]
        out = fn()
        torch.cuda.synchronize()
        return out, [c.launches - b for c, b in zip(counters, before)]

    one = lambda: policy.predict(frames[0], texts[0], return_margins=True)  # noqa: E731
    batch = lambda: policy.predict_batch(frames, texts)  # noqa: E731
    eager, n_eager = run(False, one)
    graphed, _ = run(True, one)  # captures
    assert len(policy.decode_graphs) == 1
    again, n_replay = run(True, one)  # replays
    assert len(policy.decode_graphs) == 1
    for out in (graphed, again):
        np.testing.assert_array_equal(out["action_ids"], eager["action_ids"])
        np.testing.assert_array_equal(out["margins"], eager["margins"])
    assert n_replay == n_eager and all(n > 0 for n in n_eager[:len(kernels)])
    longer = lambda: policy.predict(frames[1], texts[0] + "s", return_margins=True)  # noqa: E731
    (l_eager, _), (l_graph, _) = run(False, longer), run(True, longer)
    assert len(policy.decode_graphs) == 1  # one more prefix token, the same graph
    np.testing.assert_array_equal(l_graph["action_ids"], l_eager["action_ids"])
    np.testing.assert_array_equal(l_graph["margins"], l_eager["margins"])
    (b_eager, _), (b_graph, _) = run(False, batch), run(True, batch)
    np.testing.assert_array_equal(b_graph["action_ids"], b_eager["action_ids"])
    assert len(policy.decode_graphs) == 2
    policy.quantize(bits=None, vision_bits=None, kv_bits=qkw.get("kv_bits"))
    assert len(policy.decode_graphs) == 0


@pytest.mark.parametrize("fmt", list(QUANTIZE))
def test_serving_loop_graph_matches_eager(fmt):
    """The split engine's persistent decode batch (ServingLoop): 3
    dispatches of 4 steps replayed as its CUDA graph leave the state (cache,
    scales, tokens, positions, step counts, outputs) bit-identical to the
    same dispatches run eagerly on a twin loop, with 2 of 3 slots admitted
    from one prefill; a replay credits the wrappers with what an eager
    dispatch launches."""
    qkw, kernels = QUANTIZE[fmt]
    cfg, policy = _tiny_policy(qkw)
    proc, kv_bits = policy.processor, qkw.get("kv_bits")
    size = cfg.vision.image_size
    frames = [(np.random.RandomState(i).rand(size, size, 3) * 255).astype(np.uint8)
              for i in range(2)]
    inputs = proc(frames, ["pick up the cup", "open the top drawer of the desk"])
    T, token_range = 64, (cfg.action_token_begin_idx, cfg.spatial_token_num)
    ids = torch.full((2, T), proc.text_tokenizer.pad_id, dtype=torch.long, device=DEV)
    am = torch.zeros((2, T), dtype=torch.int32, device=DEV)
    n = inputs["input_ids"].shape[1]
    ids[:, :n] = torch.as_tensor(inputs["input_ids"], device=DEV)
    am[:, :n] = torch.as_tensor(inputs["attention_mask"], device=DEV)
    counters = kernels + (ds.norm_residual, quant.q8_residual_rmsnorm_matvec,
                          quant.q4_residual_rmsnorm_matvec)
    with torch.inference_mode():
        rows = sv.prefill_for_serving(
            policy.params, cfg, ids, pixel_values=torch.as_tensor(inputs["pixel_values"],
                                                                  device=DEV),
            intrinsic=torch.as_tensor(inputs["intrinsic"], device=DEV), attention_mask=am,
            cache_len=T + 12, token_range=token_range, kv_bits=kv_bits)
        graphed, eager = (sv.ServingLoop(policy.params, cfg, n_slots=3, cache_len=T + 12,
                                         n_tokens=12, decode_block=4, kv_bits=kv_bits,
                                         token_range=token_range, compute_dtype=torch.bfloat16,
                                         device=DEV) for _ in range(2))
        graphed.capture()  # its warm-up run advances the state once
        eager.run()
        launches = []
        for loop in (graphed, eager):
            sv.admit_rows_serving(loop.state, rows, [2, 0])
            torch.cuda.synchronize()
            before = [c.launches for c in counters]
            for _ in range(3):
                loop.step()
            torch.cuda.synchronize()
            launches.append([c.launches - b for c, b in zip(counters, before)])
    assert graphed.graph is not None and eager.graph is None
    for key, value in graphed.state.items():
        assert torch.equal(value, eager.state[key]), key
    # the last of the format's kernels is its attention kernel: every layer of every step
    assert launches[0] == launches[1] and launches[0][len(kernels) - 1] == 3 * 4 * cfg.text.num_layers
    assert (graphed.state["steps"][[2, 0]] == 12).all()


# ---------------------------------------------------------------------------
# flash attention (training path): forward, dq and dk/dv kernels
# ---------------------------------------------------------------------------

from spatialvla_tpu_torch.ops import flash_attention as fa  # noqa: E402

# name: (B, Tq, Tk, Nq, Nkv, softcap, window, prefix, valid, q_offset)
FLASH_CASES = {
    "causal_gqa_softcap": (2, 64, 64, 8, 4, 50.0, None, [0, 0], [64, 64], [0, 0]),
    "prefix_padding": (2, 96, 96, 8, 4, 50.0, None, [40, 77], [96, 81], [0, 0]),
    "window": (2, 96, 96, 4, 1, None, 17, [0, 0], [96, 96], [0, 0]),
    "window_prefix": (2, 96, 96, 8, 2, 30.0, 24, [50, 3], [90, 96], [0, 0]),
    "ragged": (2, 77, 77, 6, 3, 50.0, 33, [13, 0], [77, 70], [0, 0]),
    "q_offset": (2, 37, 101, 8, 4, 50.0, 40, [5, 0], [101, 90], [64, 50]),
    # the training path: prefix 277 of 320, one row right-padded
    "path_global": (2, 320, 320, 8, 4, 50.0, None, [277, 277], [320, 301], [0, 0]),
    "path_window": (2, 320, 320, 8, 4, 50.0, 4096, [277, 277], [320, 301], [0, 0]),
    # a group of 3 q heads a kv head
    "gqa3": (2, 96, 96, 12, 4, 50.0, None, [40, 77], [96, 81], [0, 0]),
    # a window of 17 at T=320: whole tiles of the tensor-core backward are dead
    "dead_window17": (2, 320, 320, 8, 4, 50.0, 17, [0, 5], [320, 310], [0, 0]),
}
# fp32: summation order only; bf16: plus the rounding of p relative to the
# running max (kernel) or the final max (plain) and the bf16 outputs
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_inputs(name, D, dtype, seed=0):
    B, Tq, Tk, Nq, Nkv, cap, window, prefix, valid, qoff = FLASH_CASES[name]
    g = _gen(seed)
    q, do = _randn(g, B, Tq, Nq, D, dtype=dtype), _randn(g, B, Tq, Nq, D, dtype=dtype)
    k, v = _randn(g, B, Tk, Nkv, D, dtype=dtype), _randn(g, B, Tk, Nkv, D, dtype=dtype)
    lens = [torch.tensor(x, dtype=torch.int32, device=DEV) for x in (prefix, valid, qoff)]
    kw = dict(scale=D ** -0.5, logit_softcap=cap, window=window, causal=True)
    rows = fa.allowed_rows(*lens, Tq, Tk, window=window, causal=True)
    assert rows.all()
    return (q, k, v, do), lens, kw


@pytest.mark.parametrize("name", list(FLASH_CASES))
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels(name, D, dtype):
    (q, k, v, do), lens, kw = _flash_inputs(name, D, dtype)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = fa.flash_attention_fwd(q, k, v, *lens, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == ref_lse.shape
    tol = FLASH_TOL[dtype]
    assert _rel(out, ref_out) < tol
    assert (lse - ref_lse).abs().max().item() < 1e-3
    # the backward kernels from the plain forward's LSE, so each is held alone
    delta = fa.attention_delta(ref_out, do)
    args = (q, k, v, do, ref_lse, delta, *lens)
    dq = fa.flash_attention_bwd_dq(*args, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(*args, **kw)
    assert [c.launches for c in counters] == [b + 1 for b in before]
    assert _rel(dq, fa.flash_attention_bwd_dq_plain(*args, **kw)) < tol
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_plain(*args, **kw)
    assert dk.dtype == dtype and dk.shape == k.shape
    assert _rel(dk, ref_dk) < tol
    assert _rel(dv, ref_dv) < tol


@pytest.mark.parametrize("name", ["path_global", "path_window", "dead_window17", "gqa3"])
def test_flash_backward_is_deterministic(name):
    """No atomics in the tensor-core backward: two launches, identical bits."""
    (q, k, v, do), lens, kw = _flash_inputs(name, 256, torch.bfloat16, seed=2)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
    args = (q, k, v, do, lse, fa.attention_delta(out, do), *lens)
    first = (fa.flash_attention_bwd_dq(*args, **kw), *fa.flash_attention_bwd_dkv(*args, **kw))
    second = (fa.flash_attention_bwd_dq(*args, **kw), *fa.flash_attention_bwd_dkv(*args, **kw))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [16, 24, 32, 64, 144, 256, 272])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_backward_route(dtype, D):
    """The library's route is the Python twin's: bf16 -> "mma", fp32 -> "fma"."""
    route = fa.library_bwd_route(dtype, D)
    assert route == fa.bwd_route(dtype, D)
    if D % 16 == 0 and D <= 256 and dtype != torch.float16:
        assert route == ("mma" if dtype == torch.bfloat16 else "fma")


@pytest.mark.parametrize("name", ["path_global", "path_window", "ragged", "gqa3"])
def test_flash_backward_plan_follows_the_split_rule(name):
    """The grid of each tensor-core backward kernel: 32 q rows a dq block;
    32 keys a dk/dv block, its kv head's q heads shared by a cluster of
    ``bwd_split`` blocks."""
    (q, k, v, do), lens, kw = _flash_inputs(name, 256, torch.bfloat16)
    B, Tq, Nq, _ = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = fa.bwd_split(B, Tk, Nkv, Nq // Nkv, sms)
    dq, dkv = fa.bwd_plan("dq", q, k), fa.bwd_plan("dkv", q, k)
    assert dq["route"] == dkv["route"] == "mma"
    assert dq["grid"] == (-(-Tq // fa.BWD_TILE), Nq, B) and dq["cluster"] == 1
    assert dkv["grid"] == (-(-Tk // fa.BWD_TILE), Nkv * split, B) and dkv["cluster"] == split
    assert dq["blocks_per_sm"] >= 1 and dkv["blocks_per_sm"] >= 1
    assert fa.bwd_plan("dq", q.float(), k.float())["route"] == "fma"
    assert fa.bwd_plan("dkv", q, k, fma=True)["route"] == "fma"


@pytest.mark.parametrize("name", ["causal_gqa_softcap", "window_prefix", "q_offset", "path_global"])
@pytest.mark.parametrize("D", [64, 256])
def test_flash_backward_fma_entry_in_bf16(name, D):
    """The FMA kernels kept as the bf16 yardstick agree with the plain
    version, and count no launch."""
    (q, k, v, do), lens, kw = _flash_inputs(name, D, torch.bfloat16, seed=4)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
    args = (q, k, v, do, lse, fa.attention_delta(out, do), *lens)
    counters = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    dq, dk, dv = fa.flash_attention_bwd_fma(*args, **kw)
    assert [c.launches for c in counters] == before
    tol = FLASH_TOL[torch.bfloat16]
    assert _rel(dq, fa.flash_attention_bwd_dq_plain(*args, **kw)) < tol
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_plain(*args, **kw)
    assert _rel(dk, ref_dk) < tol and _rel(dv, ref_dv) < tol
    only_dq = fa.flash_attention_bwd_fma(*args, **kw, dkv=False)
    assert only_dq[1] is None and torch.equal(only_dq[0], dq)


def test_flash_backward_takes_misaligned_operands():
    """bf16 operands that do not start on 16 bytes are copied, not refused."""
    (q, k, v, do), lens, kw = _flash_inputs("causal_gqa_softcap", 64, torch.bfloat16, seed=6)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
    delta = fa.attention_delta(out, do)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=DEV)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 != 0
    args = (shifted, k, v, do, lse, delta, *lens)
    assert torch.equal(fa.flash_attention_bwd_dq(*args, **kw),
                       fa.flash_attention_bwd_dq(q, *args[1:], **kw))


@pytest.mark.parametrize("D", [16, 24, 32, 64, 144, 256, 272])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_forward_route(dtype, D):
    """The library's forward route is the Python twin's: bf16 -> "mma",
    fp32 -> "fma"."""
    route = fa.library_fwd_route(dtype, D)
    assert route == fa.fwd_route(dtype, D)
    if D % 16 == 0 and D <= 256 and dtype != torch.float16:
        assert route == ("mma" if dtype == torch.bfloat16 else "fma")


@pytest.mark.parametrize("name", ["path_global", "ragged", "q_offset", "gqa3"])
@pytest.mark.parametrize("D", [64, 256])
def test_flash_forward_plan_takes_64_row_blocks(name, D):
    """bf16 forward calls plan the tensor-core kernel: one block of 4 warps
    a (64-row q tile, q head, batch row), no cluster; fp32 calls (and
    ``fma``) the FMA kernel's 32 rows; neither spills."""
    (q, k, _, _), _, _ = _flash_inputs(name, D, torch.bfloat16)
    B, Tq, Nq, _ = q.shape
    plan = fa.fwd_plan(q, k)
    assert plan["route"] == "mma" and plan["rows"] == fa.FWD_ROWS and plan["threads"] == 128
    assert plan["grid"] == (-(-Tq // fa.FWD_ROWS), Nq, B) and plan["cluster"] == 1
    assert plan["blocks_per_sm"] >= 1 and plan["local_bytes"] == 0
    for fma in (fa.fwd_plan(q.float(), k.float()), fa.fwd_plan(q, k, fma=True)):
        assert fma["route"] == "fma" and fma["rows"] == 32 and fma["threads"] == 256
        assert fma["grid"] == (-(-Tq // 32), Nq, B) and fma["cluster"] == 1


@pytest.mark.parametrize("name", ["path_global", "path_window", "dead_window17", "ragged"])
def test_flash_forward_is_deterministic(name):
    """The tensor-core forward: two launches, identical bits."""
    (q, k, v, _), lens, kw = _flash_inputs(name, 256, torch.bfloat16, seed=8)
    first = fa.flash_attention_fwd(q, k, v, *lens, **kw)
    second = fa.flash_attention_fwd(q, k, v, *lens, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["causal_gqa_softcap", "window_prefix", "q_offset", "path_global"])
@pytest.mark.parametrize("D", [64, 256])
def test_flash_forward_fma_entry_in_bf16(name, D):
    """The FMA forward kept as the bf16 yardstick agrees with the plain
    version, and counts no launch."""
    (q, k, v, _), lens, kw = _flash_inputs(name, D, torch.bfloat16, seed=9)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd_fma(q, k, v, *lens, **kw)
    assert fa.flash_attention_fwd.launches == before
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, *lens, **kw)
    assert out.dtype == torch.bfloat16 and _rel(out, ref_out) < FLASH_TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() < 1e-3


def test_flash_forward_takes_misaligned_operands():
    """bf16 q, k, v that do not start on 16 bytes are copied, not refused,
    and give the aligned call's bits."""
    (q, k, v, _), lens, kw = _flash_inputs("ragged", 64, torch.bfloat16, seed=10)
    shifted = []
    for t in (q, k, v):
        s = torch.empty(t.numel() + 1, dtype=t.dtype, device=DEV)[1:].view(t.shape)
        s.copy_(t)
        assert s.data_ptr() % 16 != 0
        shifted.append(s)
    got = fa.flash_attention_fwd(*shifted, *lens, **kw)
    want = fa.flash_attention_fwd(q, k, v, *lens, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_attention_autograd_on_the_card():
    """The autograd Function launches the forward once and each backward
    kernel once, and its gradients follow autograd through the reference."""
    (q, k, v, do), lens, kw = _flash_inputs("prefix_padding", 64, torch.float32, seed=1)
    grads = []
    for fn in (
        lambda q, k, v: fa.flash_attention(q, k, v, *lens, kw["scale"], kw["logit_softcap"],
                                           kw["window"], True),
        lambda q, k, v: fa.attention_reference(q, k, v, *lens, **kw),
    ):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) < 1e-4


def test_flash_attention_rejects_unsupported_shapes():
    z = lambda *s: torch.zeros(s, device=DEV)  # noqa: E731
    lens = [torch.zeros(1, dtype=torch.int32, device=DEV)] * 3
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention_fwd(z(1, 4, 2, 24), z(1, 4, 1, 24), z(1, 4, 1, 24), *lens, scale=1.0)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention_fwd(z(1, 4, 2, 32), z(1, 4, 1, 32), z(1, 4, 1, 32),
                               *[t.long() for t in lens], scale=1.0)


# ---------------------------------------------------------------------------
# checkpoints and the whole-vocabulary head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("bits", [8, 4])
def test_matvec_at_the_whole_vocabulary_head(M, bits):
    """Greedy over every id: the few-row kernels at N = 265,346 rows (611 MB
    of int8 codes, N x K just below 2^31), against their plain versions."""
    g = _gen(7)
    K, N = 2304, 265346
    x = _randn(g, M, K)
    w = _randn(g, K, N, dtype=torch.float32, std=0.02)
    w = quant.quantize_int8(w) if bits == 8 else quant.quantize_int4(w)
    kernel, plain = ((quant.q8_matvec, quant.q8_matvec_plain) if bits == 8
                     else (quant.q4_matvec, quant.q4_matvec_plain))
    got = kernel(x, w["qt"], w["scale"])
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _rel(got, plain(x, w["qt"], w["scale"])) < (1e-2 if bits == 8 else 2e-2)


def _tree_bits_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        return all(_tree_bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_bits_equal(x, y) for x, y in zip(a, b))
    assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def test_checkpoints_round_trip_on_the_card(tmp_path):
    """An HF checkpoint exported from the card and loaded back onto it, and a
    serving checkpoint saved and loaded back: bit for bit, the same ids
    through the decode graph; the whole vocabulary's greedy through a graph
    of its own follows the unfused loop under the margin rule."""
    from spatialvla_tpu_torch.convert import export_hf_checkpoint

    cfg = spatialvla_tiny(use_vision_zoe=True)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, head_dim=32, query_pre_attn_scalar=32.0, sliding_window=512))
    original = SpatialVLAPolicy.init_random(cfg, DEV, seed=0)
    export_hf_checkpoint(original.params, cfg, str(tmp_path / "hf"), processor=original.processor)
    loaded = SpatialVLAPolicy.from_hf_checkpoint(str(tmp_path / "hf"))
    assert loaded.device.type == "cuda" and _tree_bits_equal(loaded.params, original.params)
    loaded.quantize(bits=8)
    size = cfg.vision.image_size
    frame = (np.random.RandomState(0).rand(size, size, 3) * 255).astype(np.uint8)
    first = loaded.predict(frame, "pick up the cup", return_margins=True)
    loaded.save_serving(str(tmp_path / "serving"))
    served = SpatialVLAPolicy.load_serving(str(tmp_path / "serving"))
    assert _tree_bits_equal(served.params, loaded.params)
    again = served.predict(frame, "pick up the cup", return_margins=True)
    assert len(served.decode_graphs) == 1
    np.testing.assert_array_equal(again["action_ids"], first["action_ids"])
    np.testing.assert_array_equal(again["margins"], first["margins"])

    inputs = served.processor(frame, "pick up the cup")
    args = (served.params, cfg,
            torch.as_tensor(inputs["input_ids"], dtype=torch.long, device=DEV))
    kw = dict(pixel_values=torch.as_tensor(inputs["pixel_values"], device=DEV),
              intrinsic=torch.as_tensor(inputs["intrinsic"], device=DEV),
              restrict_to_action_tokens=False, return_margins=True)
    with torch.inference_mode():
        ids, _ = sv.predict_action(*args, decode_graphs=served.decode_graphs, **kw)
        ref, margins = sv.predict_action(*args, use_fused_decode=False, **kw)
    assert len(served.decode_graphs) == 2  # the whole vocabulary's graph beside the block's
    ids, ref, margins = ids[0].cpu().numpy(), ref[0].cpu().numpy(), margins[0].cpu().numpy()
    assert ids[0] == ref[0]
    for t in range(1, len(ids)):
        if margins[t] < 0.5:
            break
        assert ids[t] == ref[t]


# ---------------------------------------------------------------------------
# LoRA: the factored projection, the step, and train-state checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_lora_factored_quantized_qmatmul(bits, M):
    """qmatmul over {w: int8 / int4, a, b}: the base through the few-row
    kernel (one launch), plus the factor product, against the plain matvec
    plus the same product."""
    g = _gen(11)
    K, N, r = 2304, 2048, 32
    x = _randn(g, M, K)
    wq = (quant.quantize_int8 if bits == 8 else quant.quantize_int4)(
        _randn(g, K, N, dtype=torch.float32, std=0.02))
    a, b = _randn(g, K, r, dtype=torch.float32, std=0.02), _randn(g, r, N, dtype=torch.float32,
                                                                  std=0.02)
    kernel, plain = ((quant.q8_matvec, quant.q8_matvec_plain) if bits == 8
                     else (quant.q4_matvec, quant.q4_matvec_plain))
    before = kernel.launches
    got = quant.qmatmul(x, {"w": wq, "a": a, "b": b})
    assert kernel.launches == before + 1
    want = plain(x, wq["qt"], wq["scale"], out_dtype=x.dtype) + (x @ a.to(x.dtype)) @ b.to(x.dtype)
    assert got.shape == (M, N) and _rel(got, want) < (1e-2 if bits == 8 else 2e-2)


def _lora_setup(cfg, backend, seed=0):
    from spatialvla_tpu_torch.train import lora, optimizer, train_step as ts

    base = sv.init_params(cfg, generator=_gen(seed), device=DEV, dtype=torch.float32)
    tx = optimizer.make_optimizer(optimizer.OptimizerConfig(learning_rate=1e-3, eps=1e-3,
                                                            warmup_ratio=0.2, total_steps=10),
                                  None, None)
    state = ts.init_lora_train_state(_gen(seed + 1), base, tx,
                                     target_patterns=lora.TARGET_PRESETS["linear"], rank=8)
    with torch.no_grad():  # B non-zero, so every factor takes a gradient
        for p, f in state["trainable"]["lora"].items():
            f["b"].copy_(torch.randn(f["b"].shape, generator=_gen(seed + 2), device=DEV) * 0.02)
    step = ts.make_lora_train_step(cfg, tx, ts.TrainStepConfig(
        compute_dtype=torch.float32, attn_backend=backend, loss_chunk_size=16), rank=8)
    return base, state, step


def _lora_batch(cfg, B=2):
    rng = np.random.RandomState(0)
    N, begin = cfg.num_image_tokens, cfg.action_token_begin_idx
    ids = np.concatenate([np.full((B, N), cfg.image_token_index), rng.randint(3, 250, (B, 5)),
                          rng.randint(begin, begin + cfg.spatial_token_num, (B, 6))], axis=1)
    tt = np.zeros(ids.shape, np.int32)
    tt[:, N + 5:] = 1
    size = cfg.vision.image_size
    return {"input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
            "token_type_ids": tt, "labels": np.where(tt == 0, -100, ids),
            "pixel_values": rng.rand(B, size, size, 3).astype(np.float32),
            "intrinsic": np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]],
                                  np.float32)[None].repeat(B, 0)}


def test_tiny_lora_step_flash_against_xla():
    """Two LoRA steps of a tiny model through the flash kernels and through
    plain attention, fp32: the same losses and factors; the flash forward
    and backward launched (2L with remat, L and L a step); the base
    untouched."""
    from spatialvla_tpu_torch.ops import flash_attention as fa

    cfg = spatialvla_tiny(use_vision_zoe=True)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, head_dim=32, query_pre_attn_scalar=32.0))
    batch = _lora_batch(cfg)
    runs = {}
    for backend in ("xla", "flash"):
        base, state, step = _lora_setup(cfg, backend)
        before = {k: f.launches for k, f in (("fwd", fa.flash_attention_fwd),
                                              ("dq", fa.flash_attention_bwd_dq),
                                              ("dkv", fa.flash_attention_bwd_dkv))}
        losses = []
        for _ in range(2):
            state, metrics = step(state, base, batch)
            losses.append(float(metrics["loss"]))
        launched = {"fwd": fa.flash_attention_fwd.launches - before["fwd"],
                    "dq": fa.flash_attention_bwd_dq.launches - before["dq"],
                    "dkv": fa.flash_attention_bwd_dkv.launches - before["dkv"]}
        assert all(p.grad is None and not p.requires_grad
                   for p in (base["lm"]["layers"]["attn"]["q"], base["spatial_embed"]))
        runs[backend] = (losses, state["trainable"], launched)
    L = cfg.text.num_layers
    assert runs["flash"][2] == {"fwd": 2 * 2 * L, "dq": 2 * L, "dkv": 2 * L}
    assert runs["xla"][2] == {"fwd": 0, "dq": 0, "dkv": 0}
    np.testing.assert_allclose(runs["flash"][0], runs["xla"][0], rtol=1e-4)
    from spatialvla_tpu_torch.utils.tree import iter_leaves

    for (path, a), (_, b) in zip(iter_leaves(runs["flash"][1]), iter_leaves(runs["xla"][1])):
        assert _rel(a.detach(), b.detach()) < 1e-4, path


def test_checkpoint_manager_restores_onto_the_card(tmp_path):
    """A LoRA train state on the card saved and restored into a fresh state
    on the card: bit for bit, in place, on the card, factors still taking
    gradients."""
    from spatialvla_tpu_torch.train.checkpoints import CheckpointManager
    from spatialvla_tpu_torch.utils.tree import iter_leaves

    cfg = spatialvla_tiny(use_vision_zoe=False)
    base, state, step = _lora_setup(cfg, "xla", seed=3)
    state, _ = step(state, base, _lora_batch(cfg))
    mgr = CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
    assert mgr.save(state["step"], state)
    _, fresh, _ = _lora_setup(cfg, "xla", seed=5)
    live = dict(iter_leaves(fresh))
    restored = CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    assert restored["step"] == 1 and restored["opt_state"]["count"] == 1
    saved = dict(iter_leaves(state))
    for path, t in iter_leaves(restored):
        if torch.is_tensor(t):
            assert t is live[path] and t.device.type == "cuda", path
            assert torch.equal(t, saved[path]), path
    assert all(p.requires_grad for _, p in iter_leaves(restored["trainable"]))


def test_sum_shards_on_distinct_cards():
    """The slice form of the model axis: parts on two cards summed by one
    single-process NCCL all-reduce, each card holding the fp32 sum in the
    parts' dtype. Skips below two cards."""
    from spatialvla_tpu_torch.parallel.mesh import LocalMesh, sum_shards

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the distinct-device form of sum_shards")
    LocalMesh(model=2, devices=("cuda:0", "cuda:1"))
    parts = [_randn(_gen(s), 3, 2304).to(f"cuda:{s}") for s in range(2)]
    out = sum_shards(parts)
    want = (parts[0].float() + parts[1].float().to("cuda:0")).to(torch.bfloat16)
    for s, o in enumerate(out):
        assert o.device == torch.device(f"cuda:{s}") and o.dtype == torch.bfloat16
        assert torch.equal(o.to("cuda:0"), want)


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_predict_on_the_card(n_model):
    """shard(n_model) of the tiny int8 tree on one card: each shard's few-row
    matmuls on the kernels, no decode graph, ids held to the unsharded
    policy's under the margin rule (first token equal, then equal up to the
    first step whose margin is below 0.5)."""
    cfg = spatialvla_tiny(use_vision_zoe=True)

    def policy():
        p = SpatialVLAPolicy.init_random(cfg, DEV, seed=0)
        p.params["lm"]["lm_head"] = p.params["lm"]["lm_head"] * 50
        return p.quantize(bits=8)

    frame = (np.random.RandomState(0).rand(56, 56, 3) * 255).astype(np.uint8)
    base = policy()
    inputs = base.processor(frame, "pick up the cup")
    want, margins = (t.cpu().numpy()[0] for t in base._generate(inputs, return_margins=True))
    tp = policy().shard(n_model=n_model)
    before = quant.q8_matvec.launches
    ids = tp._generate(inputs).cpu().numpy()[0]
    assert quant.q8_matvec.launches > before and len(tp.decode_graphs) == 0
    assert ids[0] == want[0]
    for t in range(1, len(ids)):
        if margins[t] < 0.5:
            break
        assert ids[t] == want[t], (ids.tolist(), want.tolist())
