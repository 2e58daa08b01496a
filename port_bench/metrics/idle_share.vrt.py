"""Percent of the traced requests' wall in which the device ran nothing (VRT's cell; mean over the ranks)."""

from port_bench import readers


def read(run):
    return readers.idle_share(run, "serve")
