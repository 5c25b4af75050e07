"""Device milliseconds a pair of cuDNN's forward, data-gradient and
weight-gradient convolution kernels (the library's convs)."""


def read(t):
    return 1e3 * t.category_s["cudnn"] / t.pairs if t.category_s["cudnn"] > 0 else None
