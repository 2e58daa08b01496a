"""SR frames delivered to host memory over the whole window, per second (VRT's cell: its own bound)."""

from port_bench import readers


def read(run):
    return readers.rate(run, "serve")
