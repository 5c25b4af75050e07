"""Device milliseconds a pair of the work launched inside GMA's
``model.attend`` span (``to_qk``, the scores and the softmax, once a
forward) and ``model.aggregate`` spans (``to_v``, the product with the
attention and the epilogue, every update's), over the profiled stretch's
pairs (device trace). No span, no reading."""


def read(t):
    device = t.extra.get("span_device_s") or {}
    s = sum(device.get(k, 0.0) for k in ("model.attend", "model.aggregate"))
    return 1e3 * s / t.pairs if s and t.pairs else None
