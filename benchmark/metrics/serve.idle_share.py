"""Percent of the traced window with the device idle: serve_metrics.idle_share."""
from benchmark.harness import serve_metrics


def read(run):
    return serve_metrics.idle_share(run)
