"""Host milliseconds a pair that the stream spends reading and preparing
frames (``serve.load``) and filling the pinned staging tensor
(``serve.stage``), over the pairs staged, from the stretch with the spans
on and the profiler off (host clock). No span, no reading."""


def read(t):
    spans = t.extra.get("spans") or {}
    load, stage = spans.get("serve.load"), spans.get("serve.stage")
    if not load or not stage or not stage["pairs"]:
        return None
    return 1e3 * (load["total_s"] + stage["total_s"]) / stage["pairs"]
