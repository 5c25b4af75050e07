"""The share of the time in which the device ran no kernel and no copy, in
percent: one minus the union of the device operations' intervals a pair,
from the profiled stretch, times the pairs a second of the unprofiled
stretch. (The profiler slows the host, so the profiled stretch's own
length would overstate the idle time.)"""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.pairs * t.rate) if t.pairs and t.rate > 0 else None
