"""setup_s: host seconds from the process's start to the window's start:
imports, CUDA start, kernels built or loaded, the pool, warm calls."""


def read(run):
    return run.setup_s
