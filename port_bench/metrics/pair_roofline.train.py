"""The residual pair's share of its roofline in the train step's forward, percent."""

from port_bench import readers

HOOKS = ("ResidualConv",)  # the module classes whose calls the traced run hooks


def read(run):
    return readers.pair_roofline(run, "train")
