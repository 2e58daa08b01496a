"""Host ms inside the serving entry's call, before the benchmark's own wait and copy, per request (VRT's cell; rank 0's)."""

from port_bench import readers


def read(run):
    return readers.dispatch_ms(run, "serve")
