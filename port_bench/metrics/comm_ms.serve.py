"""Device ms of NCCL kernels per request, averaged over the ranks; a kernel's wait for its peers counts in it."""

from port_bench import readers


def read(run):
    return readers.per_call_ms(run, "serve", lambda t: t["nccl_s"])
