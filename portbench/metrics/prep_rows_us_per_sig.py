"""Host prep's per-row loop (key lookup, the signature and key copies,
the signing bytes) in microseconds a signature over the traced window:
the program's ``dagrider.verify.prep.rows`` span over the window's
prepared signatures."""

from portbench import program_spans


def read(ctx, name):
    return program_spans.us_per_sig(ctx, "dagrider.verify.prep.rows")
