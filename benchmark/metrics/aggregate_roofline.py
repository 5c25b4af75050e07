"""GMA's attention and aggregations against their roofline: their least
time (``gma_work.aggregate_bound``: the score product once and the value
products of every update at the bf16 peak, or q, k and each update's v and
output at the card's bandwidth, no stored probabilities) over the device
time launched inside ``model.attend`` and ``model.aggregate``, in percent.
No span, no reading."""


def read(t):
    device = t.extra.get("span_device_s") or {}
    s = sum(device.get(k, 0.0) for k in ("model.attend", "model.aggregate"))
    bound = t.extra.get("aggregate_bound_s_per_pair")
    return 100.0 * bound * t.pairs / s if s and bound and t.pairs else None
