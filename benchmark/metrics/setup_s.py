"""Seconds from the process's start to the first timed request or step:
imports, weights, inputs, kernel builds and warm-up (host clock)."""


def read(rec):
    return rec.get("setup_s")
