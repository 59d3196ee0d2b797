"""The window's seconds over the optimiser steps completed in it (host
clock; a step is a generator step and, every second step, a
discriminator step; the window holds an even number of steps)."""


def read(rec):
    n = rec.get("train_steps")
    return rec["window_s"] / n if n else None
