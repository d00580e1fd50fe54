"""The int8 decode kernels' share of their roofline: serve_metrics.decode_roofline."""
from benchmark.harness import serve_metrics


def read(run):
    return serve_metrics.decode_roofline(run)
