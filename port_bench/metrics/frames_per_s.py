"""SR frames delivered to host memory over the whole window, per second."""

from port_bench import readers


def read(run):
    return readers.rate(run, "serve")
