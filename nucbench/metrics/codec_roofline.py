"""``codec_roofline`` (%): the base-5 codec kernels' (#5, #6; the gather
cell runs #5 alone) least time by the frozen byte models, over their device
time in the traced window, on each rank (the harness averages the ranks);
nothing where the profile lost a launch."""

TAGS = ("encode_b5_kernel", "decode_b5_kernel")
WRAPPERS = ("encode_b5_stream", "decode_b5_stream")


def read(trace):
    bound = trace.work.get("codec_bound_s", 0.0)
    t = trace.kernel_s(*TAGS)
    if not trace.complete(TAGS, WRAPPERS) or bound <= 0 or t <= 0:
        return None
    return 100.0 * bound / t
