"""RAFT's all-pairs correlation and its pyramid against their roofline:
their least time (``raft_work.corr_volume_bound``: the float32 product at
the card's float32 peak, each pool's reads and writes at its bandwidth)
over the device time launched inside ``model.corr``, in percent. No span,
no reading."""


def read(t):
    s = (t.extra.get("span_device_s") or {}).get("model.corr")
    bound = t.extra.get("corr_bound_s_per_pair")
    return 100.0 * bound * t.pairs / s if s and bound and t.pairs else None
