"""``dp_host_us_per_step`` (us): the host's own work in one
``data_parallel_encode`` step of the gather cell, on each rank (the harness
averages the ranks): the mean, over the program's ``dp.encode`` spans that
begin in the traced window, of each span's duration less the
``mesh.all_gather.rows`` spans inside it (the small row-count gather, whose
read-back waits on the card).  The spans are the port's own
(``utils/tracing.py``, recorded while the profiler is open); a program
without them reads nothing.

The window is taken on the host's clock as ``stream_glue_us_per_call``
takes it: from its start to the later of its end and the end of the
benchmark's last span in it."""


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
           if name == "dp.encode" and lo <= s / 1e9 < hi}
    for name, s, e, parent, _, _ in spans:
        if name != "mesh.all_gather.rows":
            continue
        while parent >= 0 and parent not in own:  # up to the step it lies in
            parent = spans[parent][3]
        if parent >= 0:
            own[parent] -= e - s
    if not own:
        return None
    return sum(own.values()) / len(own) / 1e3
