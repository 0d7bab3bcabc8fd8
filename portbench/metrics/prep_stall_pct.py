"""The share of the verify window's seam time in which the dispatching
thread waited for a chunk's host prep running ahead on the prep engine's
thread: the program's ``dagrider.verify.prep_stall`` span over the
pipeline's ``seam_s``, over the traced window."""

from portbench import program_spans


def read(ctx, name):
    got, seam = program_spans.traced("dagrider.verify.prep_stall"), ctx.delta["seam_s"]
    return None if got is None or seam <= 0 else 100.0 * got[0] / seam
