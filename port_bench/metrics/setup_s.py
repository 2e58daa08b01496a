"""Seconds from process start to the first timed call: imports, weights, build, warm-up."""


def read(run):
    return run.setup_s
