"""torch_ops_ms.decode: device ms a call of every kernel in the trace of
the window that is not one of the program's own (``__global__`` in
``llcomp_tpu_torch/csrc``): the precompute, the colour transforms, the
copies inside the card (the restore cells)."""
from portbench import devtrace


def read(run):
    return devtrace.torch_ops_ms(run)
