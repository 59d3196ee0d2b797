"""Model FLOPs of a window step (`counts/flops.train_step`, from the
configuration's shapes) over the seconds of a step timed plainly (the
window's steps outside the traced run's profiles and stage timers) times
the H100's dense bf16 peak (the configuration's compute dtype), in %."""
from benchmark.counts import peaks


def read(rec):
    steps = rec.get("plain_step_s")
    if not steps or not rec.get("flops_per_step"):
        return None
    return rec["flops_per_step"] * len(steps) / (sum(steps)
                                                 * peaks.BF16_FLOPS) * 100
