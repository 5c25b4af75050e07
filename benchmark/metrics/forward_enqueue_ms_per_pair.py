"""Host milliseconds a pair that the model's forward takes to enqueue its
work (its ``model.forward`` span), from the stretch with the spans on and
the profiler off (host clock). No span, no reading."""


def read(t):
    s = (t.extra.get("spans") or {}).get("model.forward")
    return 1e3 * s["total_s"] / s["pairs"] if s and s["pairs"] else None
