"""Device microseconds per product in NCCL's kernels: the summed device
time of the traced window's kernels whose names start with
:data:`NCCL_PREFIX`, over its products. A receive waits in its kernel for
the sender, so this is the halo exchange and the time a rank waits for
its neighbour. The run takes the worst rank's."""

#: the prefix of NCCL's device kernels in the profiler's trace, as read on
#: an H100 under torch 2.11 with CUDA 12.8: ``ncclDevKernel_SendRecv(...)``
NCCL_PREFIX = "ncclDevKernel_"


def read(t):
    us = sum(end - start for name, start, end in t.device_ops if name.startswith(NCCL_PREFIX))
    if t.kind != "product" or not t.calls or us <= 0:
        return None
    return us / t.calls
