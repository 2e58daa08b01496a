"""SR frames delivered to rank 0's host memory over the whole window, per second (a clip split over cards: its own bound)."""

from port_bench import readers


def read(run):
    return readers.rate(run, "serve")
