"""Host milliseconds a pair that the train step takes to enqueue its work
(its ``step`` span: forward, backward and Adam issued, whatever the device
has done by then), from the stretch with the spans on and the profiler off
(host clock). No span, no reading."""


def read(t):
    s = (t.extra.get("spans") or {}).get("step")
    return 1e3 * s["total_s"] / s["pairs"] if s and s["pairs"] else None
