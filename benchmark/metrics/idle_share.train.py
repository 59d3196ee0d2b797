"""The share of the traced run's window in which no operation ran on the
card, in %: the busy seconds of a profile of the device alone over the
profiled steps, over the host clock's window around them (from a
synchronise to a synchronise)."""


def read(rec):
    t = rec.get("trace") or {}
    if not t.get("window_s") or not t.get("busy_s"):
        return None
    return (t["window_s"] - t["busy_s"]) / t["window_s"] * 100
