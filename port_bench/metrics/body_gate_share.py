"""Share of the window's ticks on which the rigid-body gate opened (the
port's device count "body_gate" over the ticks): whether the traffic
reaches the rigid-body layer."""

COUNTERS = ("body_gate",)


def read(rec):
    w = rec["window"]
    return rec["counts"]["body_gate"] / w.ticks if w.ticks else None
