"""The port's hand-written kernels against their roofline: the sum of the
least times of their calls in the profiled stretch (``kernels.bound`` of
each call's bytes and operations at the cell's shapes and precision) over
the sum of their device time, in percent. No hand kernel, no reading."""


def read(t):
    if t.hand_bound_s is None or t.category_s["hand"] <= 0:
        return None
    return 100.0 * t.hand_bound_s / t.category_s["hand"]
