"""lem_bwd's share of its roofline: the least time of one call
(counts/lem_bwd.py at the cell's shape, over the peaks of
roofline.py) over its mean device time a call in the traced window."""


def read(ctx):
    return None if ctx.trace is None else ctx.kernel_share("lem_bwd")
