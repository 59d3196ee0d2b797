"""The median over the traced run's steps of `StageTimer`'s "backward"
stage: the gradient, with the checkpointed renders run again and K2b."""
import statistics


def read(rec):
    t = [s["backward"] for s in rec.get("stage_s", []) if "backward" in s]
    return statistics.median(t) if t else None
