"""K1's share of its roofline over the traced requests' turntables, in %:
the bound seconds of the work those gaussians and cameras need
(`counts/raster.forward_view`) over K1's device seconds (CUDA events
around each launch, `ops/rasterize_cuda.event_log`)."""
import sys


def read(rec):
    bounds = rec.get("k1_bounds")
    k1 = (rec.get("trace") or {}).get("k1_s")
    if not bounds or not k1 or len(k1) != len(bounds):
        return None
    by = sorted({b["bound_by"] for b in bounds})
    print(f"k1_roofline: {len(k1)} launches, bound by {by}",
          file=sys.stderr)
    return sum(b["bound_s"] for b in bounds) / sum(k1) * 100
