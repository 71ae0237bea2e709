"""The whole step's share of the card's product peak: the matrix-product
FLOPs of the traced window's steps, counted from the shapes
(counts/mpsolver.py: the forward with grad, the pushforward's forward
without grad in the steps that draw one, and a backward at twice the
forward's), over the window's time times 495/3 TFLOP/s."""
from benchmark import roofline
from benchmark.counts.mpsolver import forward_flops


def read(ctx):
    flags = ctx.win.get("flags")
    if not flags or ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    f = forward_flops(ctx.cell.config, ctx.cell.traffic["batch"])
    flops = sum((3 + d) * f for d in flags)
    return 100.0 * flops / (ctx.win["elapsed_s"] * roofline.PRODUCT_FLOP_S)
