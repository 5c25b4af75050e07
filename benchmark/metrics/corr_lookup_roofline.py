"""RAFT's lookups against their roofline: their least time (``raft_work.
lookup_bound``: each window read and each output written once, at the
card's bandwidth) over the device time launched inside ``model.lookup``,
in percent. No span, no reading."""


def read(t):
    s = (t.extra.get("span_device_s") or {}).get("model.lookup")
    bound = t.extra.get("lookup_bound_s_per_pair")
    return 100.0 * bound * t.pairs / s if s and bound and t.pairs else None
