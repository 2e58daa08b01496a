"""Percent of the traced requests' wall in which the device ran nothing (a clip split over cards; mean over the ranks)."""

from port_bench import readers


def read(run):
    return readers.idle_share(run, "serve")
