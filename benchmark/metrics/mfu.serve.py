"""The whole request's share of the card's product peak: the matrix-product
FLOPs of a request's forwards (counts/mpsolver.py, n_windows forwards at
the bucket's batch), summed over the traced window's requests, over the
sum of their latencies times 495/3 TFLOP/s."""
from benchmark import roofline
from benchmark.counts.mpsolver import forward_flops


def read(ctx):
    lat = ctx.win.get("latencies_s")
    if not lat or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    f = forward_flops(ctx.cell.config, ctx.win["shape"]["B"])
    flops = len(lat) * ctx.cell.traffic["n_windows"] * f
    return 100.0 * flops / (sum(lat) * roofline.PRODUCT_FLOP_S)
