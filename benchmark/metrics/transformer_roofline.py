"""GMFlow's six transformer blocks against their roofline: their least time
(``gmflow_work.transformer_bound``: each of the 12 layers' FLOPs at the
bf16 peak or its bytes at the card's bandwidth, every score and
intermediate kept on the chip) over the device time launched inside
``model.transformer``, in percent. No span, no reading."""


def read(t):
    s = (t.extra.get("span_device_s") or {}).get("model.transformer")
    bound = t.extra.get("transformer_bound_s_per_pair")
    return 100.0 * bound * t.pairs / s if s and bound and t.pairs else None
