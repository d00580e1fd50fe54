"""The 95th percentile latency of the window's requests (host clock): serve_metrics.latency_p95_ms."""
from benchmark.harness import serve_metrics


def read(run):
    return serve_metrics.latency_p95_ms(run)
