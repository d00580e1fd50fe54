"""Mean real rows of the engine's batches (its counters): serve_metrics.batch_rows."""
from benchmark.harness import serve_metrics


def read(run):
    return serve_metrics.batch_rows(run)
