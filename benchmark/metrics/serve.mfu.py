"""Model FLOPs answered over the window times the bf16 peak: serve_metrics.mfu."""
from benchmark.harness import serve_metrics


def read(run):
    return serve_metrics.mfu(run)
