"""``tree_sum_xyzt_kernel``'s share of its roofline over the traced
window (``roofline.share``)."""

from portbench import roofline


def read(ctx, name):
    return roofline.share(ctx, "tree_sum_xyzt_kernel")
