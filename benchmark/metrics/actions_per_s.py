"""Actions answered in the window per second (host clock): serve_metrics.actions_per_s."""
from benchmark.harness import serve_metrics


def read(run):
    return serve_metrics.actions_per_s(run)
