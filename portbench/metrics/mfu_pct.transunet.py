"""The window's completed slices times TransUNet's logical forward FLOPs of
a slice (the frozen count of ``flops_transunet.py``) over the window's
seconds, as a share of the card's bf16 peak."""

from portbench import flops, flops_transunet


def read(run):
    if not run.window_s or not run.slices or run.device.type != "cuda":
        return None
    cfg = run.spec.config
    work = run.slices * flops_transunet.forward_flops(cfg)
    return 100.0 * work / run.window_s / flops.PEAK_FLOPS[cfg["compute_dtype"]]
