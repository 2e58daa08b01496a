"""Percent of the card's bf16 peak: the reference's forward and backward FLOPs of the window's steps over its seconds."""

from port_bench import readers


def read(run):
    return readers.mfu(run, "train")
