"""K2a's and K2b's share of their roofline over the traced steps, in %:
the bound seconds of every K2a and K2b launch (`counts/raster`: the mean
work of a view of the launch's LoD, from the gaussians and cameras those
views got; the recomputes of the checkpointed renders count as launches
too) over the two kernels' device seconds (CUDA events around each
launch)."""
import sys


def read(rec):
    bounds = rec.get("k2_bounds")
    k2 = (rec.get("trace") or {}).get("k2")
    if not bounds or not k2:
        return None
    try:
        bound_s = sum(bounds[name][size]["bound_s"] for name, size, _ in k2)
    except KeyError:
        return None
    by = sorted({b["bound_by"] for d in bounds.values() for b in d.values()})
    print(f"k2_roofline: {len(k2)} launches "
          f"({sum(n == 'K2a' for n, _, _ in k2)} K2a), bound by {by}",
          file=sys.stderr)
    return bound_s / sum(s for _, _, s in k2) * 100
