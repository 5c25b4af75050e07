"""What the stream's staging, copies and hand-outs cost: ``100 * (1 -
stream pairs/s / raw_forward pairs/s)``, both on the same frames, timed in
turns by the host clock (the serving entry's share of the stream)."""


def read(t):
    return t.extra.get("overhead_pct")
