"""Device milliseconds an iteration in operations other than cuBLAS's
matmuls and the port's SSD and attention kernels (the frozen name rules of
``harness.readers.kernel_group``): norms, activations, casts, the
convolution, copies, the loss and the optimizer's passes."""

from harness import readers

UNIT, SOURCE, LAYER = "ms", "device_trace", "model layers"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.elementwise_ms(run, "train")
