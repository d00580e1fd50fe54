"""Seconds from the process's start to the end of the warm-up (host clock)."""


def read(run):
    return run["setup_s"]
