"""Every 3x3 stride-1 SAME conv of the profiled served forwards, whichever
implementation ran it (the hand kernel's op or aten::convolution): the sum
of their roofline bounds over the sum of the device time linked to them.
Nothing is read when an op of them has no device time linked to it: the
share would then leave part of the work out of the time."""

from portbench import flops


def read(run):
    p = run.profile
    if p is None or not p.convs or p.conv_ops_without_device_time:
        return None
    # the served forward casts input and weight to the compute dtype, and
    # the conv writes that dtype
    dtype = run.spec.config["compute_dtype"]
    size = flops.ITEMSIZE[dtype]
    bound = sum(flops.conv3x3_bound_s(c.n, c.h, c.w, c.cin, c.cout, (size, size, size), dtype)
                for c in p.convs)
    return 100.0 * bound / sum(c.device_s for c in p.convs)
