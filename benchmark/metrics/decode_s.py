"""The median over requests of the program's "VAE cascade decode" span."""
import statistics


def read(rec):
    t = [d["VAE cascade decode"] for d in rec.get("timings", [])
         if "VAE cascade decode" in d]
    return statistics.median(t) if t else None
