"""Device milliseconds a pair of the kernels that are neither cuDNN's nor
the port's own: PyTorch's elementwise, reduction, copy and cast kernels
(the eager tail)."""


def read(t):
    return 1e3 * t.category_s["eager"] / t.pairs if t.category_s["eager"] > 0 else None
