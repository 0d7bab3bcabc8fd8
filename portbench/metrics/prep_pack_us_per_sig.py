"""Host prep's range checks and nibble/limb packing in microseconds a
signature over the traced window: the program's
``dagrider.verify.prep.checks`` and ``dagrider.verify.prep.pack`` spans
over the window's prepared signatures."""

from portbench import program_spans


def read(ctx, name):
    return program_spans.us_per_sig(
        ctx, "dagrider.verify.prep.checks", "dagrider.verify.prep.pack")
