"""Training clips stepped over the whole window (closed by one synchronize), per second."""

from port_bench import readers


def read(run):
    return readers.rate(run, "train")
