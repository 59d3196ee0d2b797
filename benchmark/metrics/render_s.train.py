"""The median over the traced run's steps of `StageTimer`'s "render"
stage (`train/vae_trainer`: the LoDs' forward renders, each stage ending
in a synchronise)."""
import statistics


def read(rec):
    t = [s["render"] for s in rec.get("stage_s", []) if "render" in s]
    return statistics.median(t) if t else None
