#!/usr/bin/env python
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, checking every kernel.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile DIR   # also write torch.profiler tables of
                                          # the bf16 predict forward and train step

Phases, in order; any failure exits nonzero before the last line:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel source with nvcc (all at once) and prints
     the build seconds and ptxas's registers / shared memory / spills;
  3. kernels vs plain: each kernel at the shapes the main path gives it (and
     a ragged one), bf16 (the tensor-core kernel) and f32 (the CUDA-core
     kernel), against its plain PyTorch version, with kernel / plain /
     library times and the bound from the bytes and operations of the call;
     every timed call takes the next of enough copies of its input to
     exceed the 50 MB L2, and a roofline share above 105% fails the run;
  4. backward vs plain: the 3x3 conv's dx (the same kernel on the output
     gradient with the rotated weight) and dw (cuDNN's weight gradient) at
     the training shapes, bf16 and f32, against autograd through the plain
     version, with dx kernel / plain / cuDNN dgrad / dw times;
  5. main path, predict: unet_s (widths 16..256) with seeded random weights,
     loaded through the JAX-layout weight carrier, served by
     Predictor.predict_array at (8, 512, 512) in bf16 from float and from
     uint8 images; the launch counts must show every kernel ran, and the
     masks must agree with the same Predictor in f32;
  6. train reference: one f32 train step of unet_s on (2, 64, 96) on the
     card against the same step on the CPU;
  7. main path, train: make_train_step on unet_s at (8, 512, 512), bf16
     compute with f32 master weights, on a seeded batch of bright rectangles
     on noise: 7 forward and 7 dx launches per step, all on the tensor-core
     kernel, a finite falling loss,
     step time, slices/s and peak memory; then one epoch of train_model on
     an in-memory dataset of 512x512 slices, without tqdm, PIL or cv2;
  8. a JSON ``kernels`` line (with per-shape rows), then the device line and
     the result line.

Imports nothing of JAX.  Reads nothing outside the checkout; the kernels
build into build/torch_kernels/.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from unet_medical_image_contour_segmentation_torch import exact_f32  # noqa: E402
from unet_medical_image_contour_segmentation_torch.config import TrainConfig  # noqa: E402
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import (  # noqa: E402
    load_checkpoint,
)
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig  # noqa: E402
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor  # noqa: E402
from unet_medical_image_contour_segmentation_torch.engine.train import (  # noqa: E402
    make_train_step,
    train_model,
)
from unet_medical_image_contour_segmentation_torch.kernels import _build  # noqa: E402
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3 import (  # noqa: E402
    conv3x3_nhwc,
    conv3x3_nhwc_dw,
    conv3x3_nhwc_dx,
    conv3x3_nhwc_reference,
    kernel_blocks_per_sm,
    launch_geometry,
    rotate_weight,
)
from unet_medical_image_contour_segmentation_torch.losses.compound import (  # noqa: E402
    LossConfig,
)
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (  # noqa: E402
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet_s  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BATCH, HW = 8, 512
# the 3x3 convs of unet_s that the dispatch rule sends to the kernel, at
# (BATCH, HW, HW): name, Cin, Cout, downsampling of the level
MAIN_CONVS = [
    ("inc.conv2", 16, 16, 1),
    ("down1.conv1", 16, 32, 2),
    ("down1.conv2", 32, 32, 2),
    ("down2.conv1", 32, 64, 4),
    ("up3.conv2", 32, 32, 2),
    ("up4.conv1", 32, 16, 1),
    ("up4.conv2", 16, 16, 1),
]
RAGGED = ("ragged", 1, 37, 53, 24, 40)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# each timed call reads the next of enough input copies to exceed the L2
ROTATE_BYTES = 64 * 2**20
MAX_ROOFLINE = 1.05
SLEEP_HZ = 2.0e9              # above the H100's highest SM clock (1.98 GHz)
MIN_AGREEMENT = 0.99
# bf16 rounding moves the logits of this random unet_s by ~1.5% of their
# spread, so pixels near a class boundary flip; on the CPU, seeds 0..5 with
# smooth_images agree on 99.03..99.36% of pixels, and seed 4 (99.35%,
# classes split 18/36/46%) is the one used here
MODEL_SEED = 4
# RMSprop (momentum 0.999) at this lr takes the rectangles batch's loss from
# 1.74 to 0.20 in 23 steps on the CPU (unet_s, 64x64 f32 and 128x128 bf16)
TRAIN_LR = 1e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 20


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 3, queued: bool = True):
    """(device ms, host ms) per call of ``fn(i)``, i = 0, 1, ... (the call
    index picks the input, see :func:`copies`), over ``reps`` calls.

    queued: the timed calls wait behind a sleep kernel long enough for the
    host to issue them all, so the CUDA events time the device alone and
    not the host's issue rate, which the host clock times instead.  Else
    the calls run as a caller issues them, and the events time both."""
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(i)
    issue_s = (time.perf_counter() - t0) / warmup
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # at most SLEEP_HZ cycles a second, so the sleep lasts at least sleep_s
    sleep_s = 4 * reps * issue_s + 2e-3
    if queued:
        torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
    start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(warmup + i)
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if queued and host_s > sleep_s:
        raise RuntimeError(f"the host took {host_s:.4f} s to issue {reps} calls, longer than "
                           f"the {sleep_s:.4f} s sleep they queued behind")
    return start.elapsed_time(end) / reps, host_s / reps * 1e3


def copies(t: torch.Tensor) -> list:
    """``t`` and clones of it, at least 2 and together at least ROTATE_BYTES,
    so that a call on copy i % n finds none of its input in the L2."""
    n = max(2, -(-ROTATE_BYTES // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    return smi


def phase_build() -> dict:
    """Build every source; -> ptxas's {kernel: "R registers, S/L bytes spill
    stores/loads"} for the 3x3 kernels ("f32", "mma<NT>")."""
    t0 = time.perf_counter()
    results = _build.build(["conv3x3"])
    log(f"[build] {len(results)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    usage, name, spills = {}, None, ""
    for r in results.values():
        log(f"[build] {r.name}: nvcc {r.seconds:.2f} s -> {r.library.name}")
        for line in r.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                log(f"[build]   {line.strip()}")
            m = re.search(r"conv3x3_mma_kernelILi(\d+)E|conv3x3_kernelIfE", line)
            if m and "Compiling" in line:
                name = f"mma<{m.group(1)}>" if m.group(1) else "f32"
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
            elif (m := re.search(r"Used (\d+) registers", line)) and name:
                usage[name] = f"{m.group(1)} registers, {spills}"
                name = None
    return usage


def kernel_usage(usage: dict, cin: int, cout: int, dtype) -> dict:
    """Registers, spills, shared memory and resident blocks per SM of the
    kernel that runs this shape."""
    geo = launch_geometry(1, 1, 1, cin, cout, dtype)
    key = f"mma<{geo.cout_chunk // 8}>" if geo.route == "tensor_core" else "f32"
    return dict(kernel=key, ptxas=usage.get(key, "not printed"), smem_bytes=geo.smem_bytes,
                blocks_per_sm=kernel_blocks_per_sm(cin, cout, dtype))


def conv_bound_ms(b, h, w, cin, cout, dtype):
    """(ms, "bytes" | "operations"): x and the weight read once, y written once,
    against 2*9*Cin*Cout operations per output pixel at the type's peak."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * h * w * (cin + cout) + 9 * cin * cout) * itemsize
    flops = 2 * b * h * w * 9 * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline(bound_ms: float, **timed_ms) -> float:
    """bound / kernel ms; raises when any timed call beats its bound by more
    than MAX_ROOFLINE allows (its input was then read from the L2)."""
    for what, ms in timed_ms.items():
        if bound_ms / ms > MAX_ROOFLINE:
            raise RuntimeError(f"{what} took {ms:.4f} ms against a bound of {bound_ms:.4f} ms "
                               f"({bound_ms / ms:.1%} > {MAX_ROOFLINE:.0%} of the roofline)")
    return bound_ms / timed_ms["kernel"]


def phase_kernels(usage: dict):
    """Kernel vs plain at every shape, both dtypes; bf16 timings."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(name, BATCH, HW // s, HW // s, cin, cout) for name, cin, cout, s in MAIN_CONVS]
    shapes.append(RAGGED)
    rows, max_err = [], 0.0
    for name, b, h, w, cin, cout in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(dtype)
            wt = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
                  / (3 * cin ** 0.5)).to(dtype)
            with exact_f32():
                got = conv3x3_nhwc(x, wt)
                want = conv3x3_nhwc_reference(x, wt)
                torch.cuda.synchronize()
            rtol, atol = TOL[dtype]
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
            if not ok or not torch.isfinite(got).all():
                raise RuntimeError(f"conv3x3_nhwc disagrees with its plain version at "
                                   f"{name} {(b, h, w, cin, cout)} {dtype}: max abs err {err}")
            max_err = max(max_err, err)
            if dtype != torch.bfloat16:
                log(f"[kernels] {name:12s} {str((b, h, w, cin, cout)):26s} f32  "
                    f"max_abs_err {err:.3g} ok")
                continue
            xs = copies(x)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ms, host_ms = time_ms(lambda i: conv3x3_nhwc(xs[i % len(xs)], wt), reps=20)
            plain_ms, _ = time_ms(lambda i: conv3x3_nhwc_reference(xs[i % len(xs)], wt),
                                  reps=3, warmup=1)
            library_ms, library_host_ms = time_ms(
                lambda i: F.conv2d(xs[i % len(xs)].permute(0, 3, 1, 2), w_oihw, padding=1),
                reps=20)
            del xs
            bound_ms, bound_by = conv_bound_ms(b, h, w, cin, cout, dtype)
            share = roofline(bound_ms, kernel=ms, library=library_ms)
            use = kernel_usage(usage, cin, cout, dtype)
            rows.append(dict(name=name, shape=[b, h, w, cin, cout], ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             roofline=share, max_abs_err=err, host_ms=host_ms,
                             library_host_ms=library_host_ms, **use))
            log(f"[kernels] {name:12s} {str((b, h, w, cin, cout)):26s} bf16 "
                f"max_abs_err {err:.3g} ok; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.conv2d {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"host issue {host_ms * 1e3:.1f} us (F.conv2d {library_host_ms * 1e3:.1f} us), "
                f"roofline {share:.1%}; {use['kernel']}: {use['ptxas']}, "
                f"{use['smem_bytes']} B shared, {use['blocks_per_sm']} blocks/SM")
    return rows, max_err


def phase_backward(usage: dict):
    """The autograd Function's dx (the kernel) and dw (cuDNN's weight
    gradient) at every training shape, both dtypes, against autograd through
    the plain version in f32 on the same inputs, cast once; bf16 timings.

    dx sums 9*Cout products per element and takes the forward's tolerances.
    dw sums B*H*W (up to 2M) products per element, so its absolute tolerance
    is taken relative to its largest element (the rounding error of so long
    a sum does not shrink with the element it lands in)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, max_err = [], 0.0
    for name, cin, cout, s in MAIN_CONVS:
        b, h, w = BATCH, HW // s, HW // s
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(dtype)
            wt = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
                  / (3 * cin ** 0.5)).to(dtype)
            g = torch.randn(b, h, w, cout, device="cuda", generator=gen).to(dtype)
            with exact_f32():
                xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
                conv3x3_nhwc(xg, wg).backward(g)
                xr = x.detach().float().requires_grad_()
                wr = wt.detach().float().requires_grad_()
                conv3x3_nhwc_reference(xr, wr).backward(g.float())
                torch.cuda.synchronize()
            rtol, atol = TOL[dtype]
            dx_want, dw_want = xr.grad.to(dtype).float(), wr.grad.to(dtype).float()
            dx_err = (xg.grad.float() - dx_want).abs().max().item()
            dw_err = (wg.grad.float() - dw_want).abs().max().item()
            dw_atol = atol * dw_want.abs().max().item()
            if (xg.grad.dtype != dtype or wg.grad.dtype != dtype
                    or not torch.allclose(xg.grad.float(), dx_want, rtol=rtol, atol=atol)
                    or not torch.allclose(wg.grad.float(), dw_want, rtol=rtol, atol=dw_atol)):
                raise RuntimeError(f"conv3x3 backward disagrees with the plain version at "
                                   f"{name} {(b, h, w, cin, cout)} {dtype}: dx max abs err "
                                   f"{dx_err}, dw max abs err {dw_err} (atol {dw_atol})")
            max_err = max(max_err, dx_err)
            if dtype != torch.bfloat16:
                log(f"[backward] {name:12s} {str((b, h, w, cin, cout)):26s} f32  dx max_abs_err "
                    f"{dx_err:.3g}, dw max_abs_err {dw_err:.3g} ok")
                continue
            w_rot = rotate_weight(wt)
            w_rot_oihw = w_rot.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            gs, xs = copies(g), copies(x)
            ms, host_ms = time_ms(lambda i: conv3x3_nhwc_dx(gs[i % len(gs)], wt), reps=20)
            plain_ms, _ = time_ms(lambda i: conv3x3_nhwc_reference(gs[i % len(gs)], w_rot),
                                  reps=3, warmup=1)
            library_ms, library_host_ms = time_ms(
                lambda i: F.conv2d(gs[i % len(gs)].permute(0, 3, 1, 2), w_rot_oihw, padding=1),
                reps=20)
            # dw reads x and g and writes the weight: the forward's bytes and operations
            dw_ms, _ = time_ms(lambda i: conv3x3_nhwc_dw(xs[i % len(xs)], gs[i % len(gs)]),
                               reps=20)
            del gs, xs
            bound_ms, bound_by = conv_bound_ms(b, h, w, cout, cin, dtype)
            dw_bound_ms, _ = conv_bound_ms(b, h, w, cin, cout, dtype)
            share = roofline(bound_ms, kernel=ms, library=library_ms)
            roofline(dw_bound_ms, kernel=dw_ms)
            use = kernel_usage(usage, cout, cin, dtype)
            rows.append(dict(name=name, shape=[b, h, w, cout, cin], ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             roofline=share, dw_library_ms=dw_ms, dw_bound_ms=dw_bound_ms,
                             max_abs_err=dx_err, host_ms=host_ms,
                             library_host_ms=library_host_ms, **use))
            log(f"[backward] {name:12s} {str((b, h, w, cin, cout)):26s} bf16 dx max_abs_err "
                f"{dx_err:.3g}, dw max_abs_err {dw_err:.3g} ok; dx kernel {ms:.4f} ms "
                f"({cout}->{cin}), plain {plain_ms:.4f} ms, cuDNN dgrad {library_ms:.4f} ms, "
                f"host issue {host_ms * 1e3:.1f} us (cuDNN {library_host_ms * 1e3:.1f} us), "
                f"bound {bound_ms:.4f} ms ({bound_by}), roofline {share:.1%}; {use['kernel']}: "
                f"{use['ptxas']}, {use['smem_bytes']} B shared, {use['blocks_per_sm']} blocks/SM; "
                f"dw (cuDNN wgrad) {dw_ms:.4f} ms, bound {dw_bound_ms:.4f} ms")
    return rows, max_err


def random_unet_params(seed: int, widths=(16, 32, 64, 128, 256), n_channels=1, n_classes=3):
    """unet_s weights in the JAX package's layout (numpy pytrees), from a seed:
    He-normal convs and BN affines / running stats near identity."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout, fan_in):
        return rng.normal(0, np.sqrt(2.0 / fan_in), (k, k, cin, cout)).astype(np.float32)

    def bn(c):
        return ({"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                 "bias": rng.normal(0, 0.1, c).astype(np.float32)},
                {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                 "var": rng.uniform(0.8, 1.2, c).astype(np.float32)})

    def double_conv(cin, cout):
        (p1, s1), (p2, s2) = bn(cout), bn(cout)
        params = {"conv1": {"w": conv(3, cin, cout, 9 * cin)}, "bn1": p1,
                  "conv2": {"w": conv(3, cout, cout, 9 * cout)}, "bn2": p2}
        return params, {"bn1": s1, "bn2": s2}

    w = widths
    params, state = {}, {}
    params["inc"], state["inc"] = double_conv(n_channels, w[0])
    for i, (cin, cout) in enumerate([(w[0], w[1]), (w[1], w[2]), (w[2], w[3]), (w[3], w[4])], 1):
        params[f"down{i}"], state[f"down{i}"] = double_conv(cin, cout)
    for i, (cin, cout) in enumerate([(w[4], w[3]), (w[3], w[2]), (w[2], w[1]), (w[1], w[0])], 1):
        conv_p, conv_s = double_conv(cin, cout)
        params[f"up{i}"] = {"upconv": {"w": conv(2, cin, cin // 2, cin),
                                       "b": np.zeros(cin // 2, np.float32)},
                            "conv": conv_p}
        state[f"up{i}"] = {"conv": conv_s}
    params["outc"] = {"w": conv(1, w[0], n_classes, w[0]), "b": np.zeros(n_classes, np.float32)}
    return params, state


def build_model(seed: int):
    """unet_s from seeded weights; the head bias is then centred so that the
    three classes split the pixels of a noise image, which keeps the mask
    comparison below from passing on a constant map."""
    params, state = random_unet_params(seed)
    model = unet_s()
    model.load_state_dict(state_dict_from_jax(params, state))
    probe = np.random.default_rng(seed + 1).random((1, 128, 128), dtype=np.float32)
    with torch.inference_mode():
        logits = model.eval()(torch.from_numpy(probe))
    params["outc"]["b"] = -logits.mean(dim=(0, 1, 2)).numpy()
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def check_masks(masks: np.ndarray, shape) -> None:
    if masks.shape != shape or masks.dtype != np.int32:
        raise RuntimeError(f"masks {masks.shape} {masks.dtype}, want {shape} int32")
    if masks.min() < 0 or masks.max() > 2:
        raise RuntimeError(f"mask values outside {{0, 1, 2}}: {np.unique(masks)}")


def phase_small_reference(model) -> None:
    """On a small input, the card's f32 forward (kernel + cuDNN, TF32 off)
    against the CPU forward (plain conv everywhere)."""
    x = np.random.default_rng(3).random((2, 64, 96), dtype=np.float32)
    with exact_f32(), torch.inference_mode():
        cpu = Predictor(model, device="cpu").model(torch.from_numpy(x))
        gpu = Predictor(model, device="cuda").model(torch.from_numpy(x).cuda()).cpu()
    err = (gpu - cpu).abs().max().item()
    if not err <= 1e-3 or not torch.isfinite(gpu).all():
        raise RuntimeError(f"card f32 logits differ from the CPU's by {err}")
    top2 = cpu.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 1e-3
    if not torch.equal(gpu.argmax(-1)[decided], cpu.argmax(-1)[decided]):
        raise RuntimeError("card f32 argmax differs from the CPU's on decided pixels")
    log(f"[reference] (2, 64, 96) f32 logits: card vs CPU max abs diff {err:.3g}; "
        f"argmax equal on {decided.float().mean().item():.2%} decided pixels")


def smooth_images(seed: int, n: int, hw: int, cells: int = 16) -> np.ndarray:
    """(n, hw, hw) float32 in [0, 1]: bicubic upsampling of a coarse noise grid."""
    coarse = np.random.default_rng(seed).random((n, 1, cells, cells), dtype=np.float32)
    img = F.interpolate(torch.from_numpy(coarse), size=(hw, hw), mode="bicubic")
    return img.clamp(0, 1)[:, 0].numpy()


def reset_launches() -> None:
    for fn in (conv3x3_nhwc, conv3x3_nhwc_dx):
        fn.launches = fn.tensor_core_launches = 0


def read_launches() -> dict:
    return {key: getattr(fn, attr)
            for fn in (conv3x3_nhwc, conv3x3_nhwc_dx)
            for key, attr in ((fn.__name__, "launches"),
                              (f"{fn.__name__} tensor_core", "tensor_core_launches"))}


def phase_main_path(model, profile_dir=None):
    images = smooth_images(1, BATCH, HW)
    images_u8 = np.round(images * 255).astype(np.uint8)

    pred = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    pred.predict_array(images[:1])  # warm-up: cuDNN picks its algorithms here
    torch.cuda.synchronize()

    reset_launches()
    masks = pred.predict_array(images)
    masks_u8 = pred.predict_array(images_u8)
    launches = read_launches()
    per_forward = len(MAIN_CONVS)
    if launches != {"conv3x3_nhwc": 2 * per_forward, "conv3x3_nhwc_dx": 0,
                    "conv3x3_nhwc tensor_core": 2 * per_forward,
                    "conv3x3_nhwc_dx tensor_core": 0}:
        raise RuntimeError(f"two predict forwards launched {launches}, want "
                           f"{2 * per_forward} forward launches, all on the tensor cores, "
                           f"and no dx launches")
    check_masks(masks, (BATCH, HW, HW))
    check_masks(masks_u8, (BATCH, HW, HW))
    log(f"[main] unet_s bf16 predict_array (8, 512, 512) float + uint8: "
        f"conv3x3_nhwc launches {launches['conv3x3_nhwc']} ({per_forward} per forward, all on "
        f"the tensor-core kernel); "
        f"class shares {np.bincount(masks.ravel(), minlength=3) / masks.size}")

    with exact_f32():
        ref = Predictor(model, device="cuda")
        ref_masks = ref.predict_array(images)
        ref_masks_u8 = ref.predict_array(images_u8)
    agree = float((masks == ref_masks).mean())
    agree_u8 = float((masks_u8 == ref_masks_u8).mean())
    log(f"[main] bf16 vs f32 (TF32 off) masks agree on {agree:.4%} (float) / "
        f"{agree_u8:.4%} (uint8) of pixels")
    if min(agree, agree_u8) < MIN_AGREEMENT:
        raise RuntimeError(f"bf16 masks agree with f32 on {min(agree, agree_u8):.4%} < "
                           f"{MIN_AGREEMENT:.0%} of pixels")

    # steady state, end to end (host arrays in, host masks out)
    for _ in range(3):
        pred.predict_array(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_array(images)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    # one interactive slice at a time: median and 80th percentile of 50 calls
    one = images[:1]
    for _ in range(3):
        pred.predict_array(one)
    lat = []
    for _ in range(50):
        t1 = time.perf_counter()
        pred.predict_array(one)
        lat.append((time.perf_counter() - t1) * 1e3)
    lat_p50, lat_p80 = np.percentile(lat, [50, 80])

    # the device forward alone: one batch resident on the card
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        fwd_ms, _ = time_ms(lambda i: pred.model(x).argmax(-1), reps=20, queued=False)
    log(f"[main] predict_array steady state: {BATCH * reps / dt:.1f} slices/s "
        f"({dt / reps * 1e3:.3f} ms per batch of {BATCH}, host clock); batch-1 latency "
        f"p50 {lat_p50:.3f} ms, p80 {lat_p80:.3f} ms (50 calls); device forward+argmax "
        f"{fwd_ms:.3f} ms per batch (CUDA events); peak memory {peak / 2**20:.1f} MiB")
    if profile_dir:
        profile_forward(pred, x, Path(profile_dir))
    return launches, dict(slices_per_s=BATCH * reps / dt, batch_ms=dt / reps * 1e3,
                          latency_p50_ms=lat_p50, latency_p80_ms=lat_p80,
                          forward_ms=fwd_ms, peak_mib=peak / 2**20,
                          agreement=min(agree, agree_u8))


def profile_forward(pred, x, out_dir: Path) -> None:
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with torch.inference_mode():
        for _ in range(3):
            pred.model(x).argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                pred.model(x).argmax(-1)
            torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / "predict_profile.txt").write_text(table)
    log(f"[profile] 5 bf16 forwards at (8, 512, 512); table in {out_dir}/predict_profile.txt")
    log("\n".join(table.splitlines()[:25]))


def rect_batch(seed: int, n: int, h: int, w: int) -> dict:
    """Bright rectangles on noise: (n, h, w, 1) float32 images in [0, 1] and
    (n, h, w) int32 masks, class 2 inside the rectangle and 1 elsewhere (the
    batch of tests/test_convergence.py, rectangles scaled to the image)."""
    rng = np.random.default_rng(seed)
    scale = min(h, w) / 64
    images = rng.normal(0.2, 0.05, (n, h, w, 1)).astype(np.float32)
    masks = np.ones((n, h, w), np.int32)
    for i in range(n):
        y0, x0 = (rng.integers(8, 40, 2) * scale).astype(int)
        rh, rw = (rng.integers(12, 20, 2) * scale).astype(int)
        images[i, y0:y0 + rh, x0:x0 + rw, 0] += 0.6
        masks[i, y0:y0 + rh, x0:x0 + rw] = 2
    return {"image": np.clip(images, 0, 1), "mask": masks}


def seeded_unet_s(compute_dtype=None):
    """unet_s with the seeded JAX-layout weights, unfolded, for training."""
    params, state = random_unet_params(MODEL_SEED)
    model = unet_s(compute_dtype=compute_dtype)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def one_train_step(device: str, data: dict):
    """One f32 step of the seeded unet_s on ``device`` -> host (metrics,
    clipped grads, new params, buffers)."""
    model = seeded_unet_s().to(device)
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=TRAIN_LR))
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    with exact_f32():
        metrics = step(batch, TRAIN_LR)

    def host(named):
        return {n: t.detach().float().cpu() for n, t in named}

    return ({k: v.item() for k, v in metrics.items()},
            host((n, p.grad) for n, p in model.named_parameters()),
            host(model.named_parameters()), host(model.named_buffers()))


def phase_train_reference() -> None:
    """One f32 train step (TF32 off) on the card against the CPU's.

    The loss agrees to 1e-4 relative, every gradient to 1e-3 of the model's
    largest gradient (sums in another order; a tensor whose gradient nearly
    cancels, such as a ConvTranspose bias before a train-mode BN, is ~400x
    below that largest one, so a bound relative to its own maximum would
    hold f32 rounding to 1e-6), and so the grad norm to 1e-3.  A parameter
    can differ by up to 20 * lr plus its f32 rounding: RMSprop's first step
    moves each one by just under 10 * lr * sign(g) whatever |g|, so a
    near-zero gradient whose sign the summation order flips moves it the
    other way."""
    data = rect_batch(5, 2, 64, 96)
    (m_card, g_card, p_card, b_card), (m_cpu, g_cpu, p_cpu, b_cpu) = (
        one_train_step("cuda", data), one_train_step("cpu", data))
    loss_err = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    norm_err = abs(m_card["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    g_max = max(g.abs().max().item() for g in g_cpu.values())
    grad_diff = {n: (g_card[n] - g_cpu[n]).abs().max().item() for n in g_cpu}
    grad_err = max(grad_diff.values()) / g_max
    worst = max(g_cpu, key=lambda n: grad_diff[n] / max(g_cpu[n].abs().max().item(), 1e-30))
    param_diff = torch.cat([(p_card[n] - p_cpu[n]).abs().ravel() for n in p_cpu])
    buffers_ok = all(torch.allclose(b_card[n], b_cpu[n], rtol=1e-4, atol=1e-5) for n in b_cpu)
    values = [v for v in m_card.values()] + [param_diff.max().item()]
    if (not np.all(np.isfinite(values)) or loss_err > 1e-4 or norm_err > 1e-3
            or grad_err > 1e-3 or param_diff.max().item() > 20 * TRAIN_LR + 1e-6
            or not buffers_ok):
        raise RuntimeError(f"card train step differs from the CPU's: loss rel {loss_err:.3g}, "
                           f"grad norm rel {norm_err:.3g}, grads {grad_err:.3g} of the max, params "
                           f"max {param_diff.max().item():.3g}, buffers ok {buffers_ok}")
    log(f"[train-reference] (2, 64, 96) f32 step, card vs CPU: loss {m_card['loss']:.6f} "
        f"(rel {loss_err:.3g}), grad norm {m_card['grad_norm']:.6f} (rel {norm_err:.3g}), "
        f"grads max abs diff {grad_err:.3g} of the largest gradient {g_max:.3g} (relative "
        f"to its own max, worst {worst}: {grad_diff[worst]:.3g} of "
        f"{g_cpu[worst].abs().max().item():.3g}), params max abs diff "
        f"{param_diff.max().item():.3g} ({(param_diff > 1e-6).float().mean().item():.4%} "
        f"of elements over 1e-6), BN buffers within 1e-4")


def phase_train(profile_dir=None):
    """make_train_step on the seeded unet_s at (BATCH, HW, HW), bf16 compute,
    one resident batch: launches per step, the loss curve, step time."""
    model = seeded_unet_s(torch.bfloat16).cuda()
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=TRAIN_LR))
    batch = {k: torch.from_numpy(v).cuda() for k, v in rect_batch(6, BATCH, HW, HW).items()}
    per_step = len(MAIN_CONVS)

    reset_launches()
    losses = [step(batch, TRAIN_LR)["loss"]]
    if set(read_launches().values()) != {per_step}:
        raise RuntimeError(f"one train step launched {read_launches()}, want {per_step} "
                           f"forward and {per_step} dx launches, all on the tensor cores")
    for _ in range(TRAIN_WARMUP - 1):
        losses.append(step(batch, TRAIN_LR)["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        losses.append(step(batch, TRAIN_LR)["loss"])
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    launches = read_launches()
    if set(launches.values()) != {per_step * n_steps}:
        raise RuntimeError(f"{n_steps} train steps launched {launches}, want "
                           f"{per_step * n_steps} of each, all on the tensor cores")
    curve = torch.stack(losses).tolist()
    if not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise RuntimeError(f"the train loss is not finite and falling: {curve}")
    log(f"[train] unet_s bf16 make_train_step ({BATCH}, {HW}, {HW}): {2 * per_step} kernel "
        f"launches per step ({per_step} forward + {per_step} dx, all on the tensor-core "
        f"kernel), {launches} in {n_steps} "
        f"steps; loss {' '.join(f'{v:.4f}' for v in curve)}")
    log(f"[train] step {step_ms:.3f} ms (CUDA events, {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-ups, batch resident), {BATCH * 1e3 / step_ms:.1f} slices/s, "
        f"peak memory {peak / 2**20:.1f} MiB")
    if profile_dir:
        profile_train(step, batch, Path(profile_dir))
    return launches, dict(step_ms=step_ms, slices_per_s=BATCH * 1e3 / step_ms,
                          peak_mib=peak / 2**20, loss_first=curve[0], loss_last=curve[-1])


def profile_train(step, batch, out_dir: Path) -> None:
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch, TRAIN_LR)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    (out_dir / "train_profile.txt").write_text(table)
    log(f"[profile] 3 bf16 train steps at ({BATCH}, {HW}, {HW}); table in "
        f"{out_dir}/train_profile.txt")
    log("\n".join(table.splitlines()[:30]))


class ArrayDataset:
    """In-memory slices in the BasicDataset protocol."""

    mask_values = [0, 128, 255]

    def __init__(self, data: dict):
        self.data = data

    def __len__(self) -> int:
        return len(self.data["mask"])

    def __getitem__(self, i: int) -> dict:
        return {"image": self.data["image"][i], "mask": self.data["mask"][i]}


HOST_ONLY_MODULES = ("tqdm", "PIL", "cv2")


def phase_train_model(n_train: int = 32):
    """One epoch of train_model on in-memory 512x512 slices, with progress,
    post-processing and prediction dumps off, checkpoints into a temp dir;
    it must not import tqdm, PIL or cv2."""
    train_set = ArrayDataset(rect_batch(7, n_train, HW, HW))
    val_set = ArrayDataset(rect_batch(8, 2 * BATCH, HW, HW))
    records = []
    before = {m for m in HOST_ONLY_MODULES if m in sys.modules}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(model="unet_s", epochs=1, batch_size=BATCH, learning_rate=TRAIN_LR,
                          amp=True, num_workers=4, checkpoint_every=1,
                          checkpoint_after_frac=0.0,
                          dir_checkpoint=os.path.join(tmp, "checkpoints"),
                          predictions_dir=os.path.join(tmp, "predictions"),
                          save_val_predictions=False, val_postprocess=False, progress=False,
                          log_every=0)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            result = train_model(cfg, model=seeded_unet_s(torch.bfloat16), train_set=train_set,
                                 val_set=val_set, device="cuda",
                                 metric_backends=[lambda kind, rec: records.append((kind, rec))])
            seconds = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        final = load_checkpoint(os.path.join(tmp, "model_epoch1.npz"))
        periodic = os.path.exists(os.path.join(tmp, "checkpoints", "checkpoint_epoch1.npz"))
    loaded = sorted({m for m in HOST_ONLY_MODULES if m in sys.modules} - before)
    val = [rec for kind, rec in records if kind == "validation"]
    steps = n_train // BATCH
    train_losses = [rec["loss"] for kind, rec in records if kind == "train_step"]
    if (result.step != steps or final["step"] != steps or final["opt_state"] is None
            or not periodic or loaded or len(val) != 1 or len(train_losses) != steps
            or not np.all(np.isfinite(train_losses))
            or not np.all(np.isfinite([val[0][k] for k in ("dice", "dice_postprocessed",
                                                            "min_dice")]))):
        raise RuntimeError(f"train_model epoch: steps {result.step} (want {steps}), checkpoint "
                           f"step {final['step']}, opt_state {final['opt_state'] is not None}, "
                           f"periodic checkpoint {periodic}, imported {loaded}, records {records}")
    v = val[0]
    log(f"[train_model] 1 epoch, {n_train} slices {HW}x{HW} in batches of {BATCH}: "
        f"{v['slices_per_sec']:.1f} slices/s (host clock, the epoch's train loop), "
        f"{seconds:.2f} s end to end with validation and checkpoints; validation "
        f"(dice, dice_postprocessed, min_dice) = ({v['dice']:.4f}, "
        f"{v['dice_postprocessed']:.4f}, {v['min_dice']:.4f}); train losses "
        f"{' '.join(f'{x:.4f}' for x in train_losses)}; no import of {HOST_ONLY_MODULES}")
    return dict(slices_per_s=v["slices_per_sec"], seconds=seconds, dice=v["dice"],
                dice_postprocessed=v["dice_postprocessed"], min_dice=v["min_dice"])


def shape_rows(rows) -> list:
    """The per-shape numbers of the ``kernels`` line."""
    return [{k: r[k] for k in ("name", "shape", "ms", "bound_ms", "library_ms", "roofline")}
            for r in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write torch.profiler tables of the bf16 forward and train step to DIR")
    args = ap.parse_args(argv)

    smi = phase_device()
    usage = phase_build()
    rows, max_err = phase_kernels(usage)
    bwd_rows, bwd_err = phase_backward(usage)
    model = build_model(seed=MODEL_SEED)
    phase_small_reference(model)
    launches, main = phase_main_path(model, args.profile)
    phase_train_reference()
    train_launches, train = phase_train(args.profile)
    train["epoch"] = phase_train_model()

    main_rows = [r for r in rows if r["name"] != "ragged"]
    source = "unet_medical_image_contour_segmentation_torch/csrc/conv3x3.cu"
    pallas = "unet_medical_image_contour_segmentation_tpu/ops/pallas_conv.py"
    kernels = [{
        "name": "conv3x3_nhwc",
        "route": "cuda",
        "source": source,
        "replaces": f"{pallas}:133",
        # the predict path's two forwards plus the train path's steps
        "launches": launches["conv3x3_nhwc"] + train_launches["conv3x3_nhwc"],
        "max_abs_err": max_err,
        # per unet_s forward: the sum over the main path's shapes
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "shapes": shape_rows(main_rows),
    }, {
        # the same kernel as the input gradient in the train step's backward
        "name": "conv3x3_nhwc_dx",
        "route": "cuda",
        "source": source,
        "replaces": f"{pallas}:183",
        "launches": train_launches["conv3x3_nhwc_dx"],
        "max_abs_err": bwd_err,
        # per unet_s train step: the sum over the training shapes
        "ms": sum(r["ms"] for r in bwd_rows),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows),
        "bound_ms": sum(r["bound_ms"] for r in bwd_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd_rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in bwd_rows),
        "shapes": shape_rows(bwd_rows),
    }]
    fwd = kernels[0]
    log(f"[kernels] per forward: kernel {fwd['ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
        f"(roofline {fwd['bound_ms'] / fwd['ms']:.1%}), F.conv2d {fwd['library_ms']:.4f} ms, "
        f"kernel / library {fwd['ms'] / fwd['library_ms']:.3f}")
    log(f"[backward] per train step: dx kernel {kernels[1]['ms']:.4f} ms, bound "
        f"{kernels[1]['bound_ms']:.4f} ms, cuDNN dgrad {kernels[1]['library_ms']:.4f} ms, "
        f"kernel / library {kernels[1]['ms'] / kernels[1]['library_ms']:.3f}; dw (cuDNN "
        f"wgrad) {sum(r['dw_library_ms'] for r in bwd_rows):.4f} ms, bound "
        f"{sum(r['dw_bound_ms'] for r in bwd_rows):.4f} ms")
    log(f"[main] {json.dumps(main)}")
    log(f"[train] {json.dumps(train)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
