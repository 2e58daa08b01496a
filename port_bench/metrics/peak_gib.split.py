"""Peak device memory allocated during the window, GiB (a clip split over cards; the largest rank's)."""

from port_bench import readers


def read(run):
    return readers.peak_gib(run, "serve")
