"""The 90th percentile of every request's latency in the window, hand-over to frames in host memory, in ms."""

from port_bench import readers


def read(run):
    return readers.latency_ms(run, 90.0)
