"""The median over requests of the program's "8-view turntable render"
span, per view, in ms."""
import statistics


def read(rec):
    t = [d["8-view turntable render"] for d in rec.get("timings", [])
         if "8-view turntable render" in d]
    return statistics.median(t) / rec["views"] * 1e3 if t else None
