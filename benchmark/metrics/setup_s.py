"""setup_s: host seconds from the process's start to the window's start:
imports, the kernel build or its load from the checkout's cache, the
models, the data and weights drawn on the device, the three checked steps
and the FLOP count."""


def read(run):
    return run.setup_s
