"""Device milliseconds a pair of the work launched inside GMFlow's
``model.match`` and ``model.propagate`` spans (the global matching and the
flow propagation, each a softmax over all 7168 pixels of a 448x1024
frame), over the profiled stretch's pairs (device trace). No span, no
reading."""


def read(t):
    device = t.extra.get("span_device_s") or {}
    s = sum(device.get(k, 0.0) for k in ("model.match", "model.propagate"))
    return 1e3 * s / t.pairs if s and t.pairs else None
