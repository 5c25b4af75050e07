"""The 95th percentile, over every pair the stream handed out in its
unprofiled stretches, of the latency from the pull of a pair's second frame
to the hand-out of its flow (the serving entry's lag under a closed loop)."""


def read(t):
    return t.extra.get("p95_ms")
