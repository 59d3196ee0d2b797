"""Model FLOPs of one extraction request (`counts/flops.vae_encode` of
one instance of 4 views at 512², from the configuration's shapes) over
the request's seconds times the H100's dense TF32 peak (the network
products run in TF32), in %; the median over the window's requests. The
image cell's reader: both drivers record `latencies` and
`flops_per_request`."""
from benchmark.metrics.request_mfu import read  # noqa: F401
