"""Peak device memory allocated during the window, GiB."""

from port_bench import readers


def read(run):
    return readers.peak_gib(run, "train")
