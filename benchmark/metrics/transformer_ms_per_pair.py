"""Device milliseconds a pair of the work launched inside GMFlow's
``model.transformer`` span (the positions and the six blocks of window
self- and cross-attention), over the profiled stretch's pairs (device
trace). No span, no reading."""


def read(t):
    s = (t.extra.get("span_device_s") or {}).get("model.transformer")
    return 1e3 * s / t.pairs if s and t.pairs else None
