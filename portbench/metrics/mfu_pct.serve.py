"""The window's completed slices times the logical forward FLOPs of a slice
(the frozen closed form) over the window's seconds, as a share of the
card's bf16 peak."""

from portbench import flops


def read(run):
    if not run.window_s or not run.slices or run.device.type != "cuda":
        return None
    cfg, s = run.spec.config, run.spec.slices
    work = run.slices * flops.unet_forward_flops(cfg, s["height"], s["width"])
    return 100.0 * work / run.window_s / flops.PEAK_FLOPS[cfg["compute_dtype"]]
