"""``readbacks_per_query`` (reads): the program's ``align.stream.readback``
spans (each one blocking read of a value from the card) that begin in the
traced window, per query answered there.  The spans are the port's own
(``utils/tracing.py``); a program without that recorder reads nothing.  The
window is taken on the host's clock, as ``stream_glue_us_per_call`` takes
it: from its start to the later of its end and the end of the benchmark's
last span in it."""


def read(trace):
    try:
        from cute_nucleotides_tpu_torch.utils import tracing
    except ImportError:
        return None
    q = trace.work.get("queries", 0)
    if trace.window_s <= 0:  # the profile lost its markers: no window to read in
        return None
    lo = trace.window[0]
    hi = max([trace.window[1]] + [e for _, _, e in trace.spans])
    n = sum(1 for name, s, *_ in tracing.spans() if name == "align.stream.readback" and lo <= s / 1e9 < hi)
    if not q or not n:
        return None
    return n / q
