"""The host-to-card copies of a dispatch's two transfer arrays in
milliseconds a dispatch over the traced window: the program's
``dagrider.verify.copy_in`` span over its dispatch count."""

from portbench import program_spans


def read(ctx, name):
    return program_spans.ms_per_dispatch(ctx, "dagrider.verify.copy_in")
