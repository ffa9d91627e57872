"""The window's trained slices times 3x the logical forward FLOPs of a slice
(forward, dgrad, wgrad) over the window's seconds, as a share of the card's
bf16 peak."""

from portbench import flops


def read(run):
    if not run.window_s or not run.slices or run.device.type != "cuda":
        return None
    cfg, s = run.spec.config, run.spec.slices
    work = run.slices * flops.TRAIN_FLOPS_PER_FORWARD * flops.unet_forward_flops(
        cfg, s["height"], s["width"])
    return 100.0 * work / run.window_s / flops.PEAK_FLOPS[cfg["compute_dtype"]]
