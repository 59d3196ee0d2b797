"""The median over requests of the program's own stage spans, "stage-1
sample" + "stage-2 sample" (`cli.sample.sample_request`'s `timings`:
host clock, a synchronise at each stage's end)."""
import statistics


def read(rec):
    t = [d["stage-1 sample"] + d["stage-2 sample"]
         for d in rec.get("timings", []) if "stage-2 sample" in d]
    return statistics.median(t) if t else None
