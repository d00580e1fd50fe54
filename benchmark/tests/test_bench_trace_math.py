"""The trace arithmetic: the union of device intervals, the idle share over
the benchmark's own window, and the idle gaps labelled by the host."""
import pytest

from benchmark.harness import trace


def test_union():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41), (2, 3)]
    assert trace.union_us(iv) == 12 + 10 + 1
    assert trace.union_us([]) == 0


def _k(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 100, "dur": 1000, "tid": 1},
        _k("void qmatvec_kernel<8, false>(float*)", 50, 100, 1),  # cut to [100, 150]
        _k("void qmatvec_kernel<8, true>(float*)", 140, 60, 2),  # [140, 200]
        _k("ampere_bf16_gemm", 500, 100, 3),  # [500, 600]
        _k("ampere_bf16_gemm", 1050, 100, 4),  # cut to [1050, 1100]
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 490, "dur": 5, "tid": 7,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1040, "dur": 5, "tid": 7,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 150, "dur": 340, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 140, "dur": 360, "tid": 7},
    ]


def test_summary_window_busy_and_gaps():
    s = trace.summary(_events())
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((100 + 100 + 50) * 1e-6)
    assert s["ops_s"]["qmatvec_kernel"] == pytest.approx(110e-6)
    assert s["device_ops"][0] == ["ampere_bf16_gemm", pytest.approx(150e-6)]
    gaps = dict(s["idle_gaps"])
    # [200, 500] opened while the launching thread was inside aten::copy_
    assert gaps["aten::copy_"] == pytest.approx(300e-6)
    assert gaps["host: no range"] == pytest.approx(450e-6)  # [600, 1050]: no range on tid 7 at 600
    assert sum(gaps.values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_idle_share_reader():
    from benchmark.harness import cells

    s = trace.summary(_events())
    assert cells.reader("serve.idle_share")({"trace": s}) == pytest.approx(75.0)
    assert cells.reader("serve.idle_share")({"trace": None}) is None


def test_no_window_no_summary():
    assert trace.summary([e for e in _events() if e["cat"] != "user_annotation"]) is None


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::flash_fwd_mma_kernel<256>(bf16 const*)") \
        == "flash_fwd_mma_kernel"
