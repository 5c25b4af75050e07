"""The whole forward's (or step's) share of the card's peak: the analytic
model FLOPs a pair times the unprofiled pairs a second, over the peak of the
cell's precision, in percent."""


def read(t):
    return 100.0 * t.flops_per_pair * t.rate / t.peak_flops if t.rate > 0 else None
