"""Model FLOPs of one request (`counts/flops.request`, from the
configuration's shapes) over the request's seconds times the H100's dense
TF32 peak (the network products run in TF32), in %; the median over the
window's requests."""
import statistics

from benchmark.counts import peaks


def read(rec):
    lat = rec.get("latencies")
    if not lat or not rec.get("flops_per_request"):
        return None
    return statistics.median(rec["flops_per_request"] / (t * peaks.TF32_FLOPS)
                             for t in lat) * 100
