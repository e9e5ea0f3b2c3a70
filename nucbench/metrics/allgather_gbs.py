"""``allgather_gbs`` (GB/s): the bytes each rank receives from the others
in the traced window's all-gathers, over the device time of NCCL's
all-gather kernels there."""


def read(trace):
    t = trace.kernel_s("AllGather")
    got = trace.work.get("allgather_recv_bytes", 0)
    if t <= 0 or not got:
        return None
    return got / t / 1e9
