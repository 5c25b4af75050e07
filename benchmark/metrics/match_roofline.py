"""GMFlow's global matching and propagation against their roofline: their
least time (``gmflow_work.match_bound``: the two global products and the
propagation's projections at the bf16 peak, their scores kept on the
chip) over the device time launched inside ``model.match`` and
``model.propagate``, in percent. No span, no reading."""


def read(t):
    device = t.extra.get("span_device_s") or {}
    s = sum(device.get(k, 0.0) for k in ("model.match", "model.propagate"))
    bound = t.extra.get("match_bound_s_per_pair")
    return 100.0 * bound * t.pairs / s if s and bound and t.pairs else None
