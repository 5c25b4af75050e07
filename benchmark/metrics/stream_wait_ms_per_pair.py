"""Host milliseconds a pair that the stream waits on a dispatch's copy-back
event before handing its flows out (``serve.wait``), from the stretch with
the spans on and the profiler off (host clock). No span, no reading."""


def read(t):
    s = (t.extra.get("spans") or {}).get("serve.wait")
    return 1e3 * s["total_s"] / s["pairs"] if s and s["pairs"] else None
