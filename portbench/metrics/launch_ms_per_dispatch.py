"""The host's time to enqueue a dispatch's device program (unpack, gather,
tree and finish launches, the event record) in milliseconds a dispatch
over the traced window: the program's ``dagrider.verify.launch`` span over
its dispatch count."""

from portbench import program_spans


def read(ctx, name):
    return program_spans.ms_per_dispatch(ctx, "dagrider.verify.launch")
