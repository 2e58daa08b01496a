"""Percent of the chips' bf16 peak: the reference's FLOPs of the window's requests over its seconds (VRT's cell)."""

from port_bench import readers


def read(run):
    return readers.mfu(run, "serve")
