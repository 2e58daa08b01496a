"""Device ms of the kernels launched inside WindowAttention's calls, per request."""

from port_bench import readers

HOOKS = ("WindowAttention",)  # the module classes whose calls the traced run hooks


def read(run):
    return readers.module_ms(run, "serve", "WindowAttention")
