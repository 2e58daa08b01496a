"""Device ms of the kernels launched inside SecondOrderDeformableAlignment's calls, per request."""

from port_bench import readers

HOOKS = ("SecondOrderDeformableAlignment",)  # the module classes whose calls the traced run hooks


def read(run):
    return readers.module_ms(run, "serve", "SecondOrderDeformableAlignment")
