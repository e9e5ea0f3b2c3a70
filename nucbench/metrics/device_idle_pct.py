"""``device_idle_pct`` (%): 1 minus the union of the device-busy intervals
over the traced window (a copy that overlaps a kernel counts once)."""


def read(trace):
    if not trace.events or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
