"""The median over the traced requests of the program's `ga.encode.fps`
span (`ops/fps.sample_farthest_points`: the 768 anchors from 4,096
points), device ms (the span recorder's CUDA events; host ms on the
CPU)."""
import statistics


def read(rec):
    t = [s["ga.encode.fps"] for s in rec.get("spans", [])
         if "ga.encode.fps" in s]
    return statistics.median(t) * 1e3 if t else None
