"""Host ms inside the train step's call, per step (the host may run ahead of the device)."""

from port_bench import readers


def read(run):
    return readers.dispatch_ms(run, "train")
