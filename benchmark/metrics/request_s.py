"""The window's seconds over the requests completed in it (host clock;
the window runs from the first request's start to the last one's end)."""


def read(rec):
    lat = rec.get("latencies")
    return rec["window_s"] / len(lat) if lat else None
