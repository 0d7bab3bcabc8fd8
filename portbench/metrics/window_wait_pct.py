"""The share of the verify window's seam time in which the host was
blocked on the card, from the pipeline's own counters over the window
(``VerifierPipeline.wait_s`` over ``seam_s``)."""


def read(ctx, name):
    seam = ctx.delta["seam_s"]
    return None if seam <= 0 else 100.0 * ctx.delta["wait_s"] / seam
