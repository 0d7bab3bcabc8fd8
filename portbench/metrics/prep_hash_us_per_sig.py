"""Host prep's challenge hash (the message join and the SHA-512 batch) in
microseconds a signature over the traced window: the program's
``dagrider.verify.prep.hash`` span over the window's prepared signatures."""

from portbench import program_spans


def read(ctx, name):
    return program_spans.us_per_sig(ctx, "dagrider.verify.prep.hash")
