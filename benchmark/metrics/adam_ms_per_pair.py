"""Device milliseconds a pair of the work launched inside the step's
``step.adam`` span (the weight decay's add and the foreach Adam update),
over the profiled stretch's pairs (device trace). No span, no reading."""


def read(t):
    s = (t.extra.get("span_device_s") or {}).get("step.adam")
    return 1e3 * s / t.pairs if s and t.pairs else None
