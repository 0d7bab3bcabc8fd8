"""Host prep's microseconds a signature over the window: the change in
``CUDAVerifier.total_prepare_s`` over the change in
``total_sigs_dispatched`` (the host clock around parsing, the range
checks, the challenge hash and the packing)."""


def read(ctx, name):
    sigs = ctx.delta["prepared_sigs"]
    return None if sigs <= 0 else 1e6 * ctx.delta["prepare_s"] / sigs
