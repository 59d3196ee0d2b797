"""`torch.cuda.max_memory_allocated()` over the set-up and the window,
after `reset_peak_memory_stats()` at the start of set-up, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec.get("peak_bytes") else None
