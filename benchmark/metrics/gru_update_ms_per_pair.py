"""Device milliseconds a pair of the work launched inside RAFT's
``model.update`` spans (the motion encoder, the ConvGRU, the flow head and
the coordinates, every update's), over the profiled stretch's pairs
(device trace). No span, no reading."""


def read(t):
    s = (t.extra.get("span_device_s") or {}).get("model.update")
    return 1e3 * s / t.pairs if s and t.pairs else None
