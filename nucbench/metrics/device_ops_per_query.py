"""``device_ops_per_query`` (ops): device operations (kernels, eager ops,
copies, fills) the profile saw in the traced window, per query answered
there."""


def read(trace):
    q = trace.work.get("queries", 0)
    if not q or not trace.events:
        return None
    return len(trace.events) / q
