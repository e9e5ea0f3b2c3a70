"""``enqueue_us_per_batch`` (us): host time to enqueue one
``encode_checked`` and ``decode_checked`` round trip, with no synchronize:
the benchmark's ``probe.enqueue`` spans, bursts of round trips started right
after a synchronize and short enough that the launch queue never fills."""


def read(trace):
    spans = [e - s for name, s, e in trace.spans if name == "probe.enqueue"]
    n = trace.work.get("probe.round_trips", 0)
    if not spans or not n:
        return None
    return 1e6 * sum(spans) / n
