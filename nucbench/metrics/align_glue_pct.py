"""``align_glue_pct`` (%): the share of the traced window's device-busy time
spent outside kernel #19 (the eager Peq build, the ``torch.where``s and the
copies around it)."""


def read(trace):
    busy = trace.busy_s()
    scan = trace.busy_s("myers_")
    if busy <= 0 or scan <= 0:
        return None
    return 100.0 * (busy - scan) / busy
