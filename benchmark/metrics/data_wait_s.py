"""The median over the window's steps of the benchmark's span around the
data iterator's `next()`: the seconds the step waited for its batch."""
import statistics


def read(rec):
    w = rec.get("data_wait")
    return statistics.median(w) if w else None
