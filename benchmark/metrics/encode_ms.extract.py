"""The median over the traced requests of the program's `ga.encode` span
(`models/vae.PointVAE.encode`: the encoder and the quant MLP), device ms
(the span recorder's CUDA events; host ms on the CPU)."""
import statistics


def read(rec):
    t = [s["ga.encode"] for s in rec.get("spans", []) if "ga.encode" in s]
    return statistics.median(t) * 1e3 if t else None
