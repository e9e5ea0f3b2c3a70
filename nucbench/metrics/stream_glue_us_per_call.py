"""``stream_glue_us_per_call`` (us): the host's own work in one
``best_match_stream`` call: the mean, over the program's ``align.stream``
spans that begin in the traced window, of each span's duration less its
``align.stream.readback`` children (the host waiting on the card for a
value).  The spans are the port's own (``utils/tracing.py``, recorded while
the profiler is open); a program without that recorder reads nothing.

The window is taken on the host's clock: from its start to the later of
its end and the end of the benchmark's last span in it.  Its end comes from
the profile's clock, tied to the host's at the start marker alone, and can
land before the host's (0.06 to 124 ms in the guide cell, on an H100), which
would leave out the window's last calls."""


def read(trace):
    try:
        from cute_nucleotides_tpu_torch.utils import tracing
    except ImportError:
        return None
    if trace.window_s <= 0:  # the profile lost its markers: no window to read in
        return None
    lo = trace.window[0]
    hi = max([trace.window[1]] + [e for _, _, e in trace.spans])
    spans = tracing.spans()
    own = {i: e - s for i, (name, s, e, _, _, _) in enumerate(spans)
           if name == "align.stream" and lo <= s / 1e9 < hi}
    for name, s, e, parent, _, _ in spans:
        if name == "align.stream.readback" and parent in own:
            own[parent] -= e - s
    if not own or not trace.work.get("queries", 0):
        return None
    return sum(own.values()) / len(own) / 1e3
