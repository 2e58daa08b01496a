"""The 90th percentile of every request's latency in the window, hand-over to frames in rank 0's host memory, in ms (a clip split over cards)."""

from port_bench import readers


def read(run):
    return readers.latency_ms(run, 90.0)
