#!/usr/bin/env python
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, checking every kernel.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table of
                                          # the bf16 predict forward to DIR

Phases, in order; any failure exits nonzero before the last line:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel source with nvcc (all at once) and prints
     the build seconds and ptxas's registers / shared memory / spills;
  3. kernels vs plain: each kernel at the shapes the main path gives it (and
     a ragged one), bf16 and f32, against its plain PyTorch version, with
     kernel / plain / library times and the bound from the bytes and
     operations of the call;
  4. main path: unet_s (widths 16..256) with seeded random weights, loaded
     through the JAX-layout weight carrier, served by Predictor.predict_array
     at (8, 512, 512) in bf16 from float and from uint8 images; the launch
     counts must show every kernel ran, and the masks must agree with the
     same Predictor in f32;
  5. a JSON ``kernels`` line, then the device line and the result line.

Imports nothing of JAX.  Reads nothing outside the checkout; the kernels
build into build/torch_kernels/.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from unet_medical_image_contour_segmentation_torch import exact_f32  # noqa: E402
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor  # noqa: E402
from unet_medical_image_contour_segmentation_torch.kernels import _build  # noqa: E402
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3 import (  # noqa: E402
    conv3x3_nhwc,
    conv3x3_nhwc_reference,
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
MIN_AGREEMENT = 0.99
# bf16 rounding moves the logits of this random unet_s by ~1.5% of their
# spread, so pixels near a class boundary flip; on the CPU, seeds 0..5 with
# smooth_images agree on 99.03..99.36% of pixels, and seed 4 (99.35%,
# classes split 18/36/46%) is the one used here
MODEL_SEED = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_build() -> None:
    t0 = time.perf_counter()
    results = _build.build(["conv3x3"])
    log(f"[build] {len(results)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for r in results.values():
        log(f"[build] {r.name}: nvcc {r.seconds:.2f} s -> {r.library.name}")
        for line in r.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                log(f"[build]   {line.strip()}")


def conv_bound_ms(b, h, w, cin, cout, dtype):
    """(ms, "bytes" | "operations"): x and the weight read once, y written once,
    against 2*9*Cin*Cout operations per output pixel at the type's peak."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (b * h * w * (cin + cout) + 9 * cin * cout) * itemsize
    flops = 2 * b * h * w * 9 * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
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
            x_nchw = x.permute(0, 3, 1, 2)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ms = time_ms(lambda: conv3x3_nhwc(x, wt), reps=20)
            plain_ms = time_ms(lambda: conv3x3_nhwc_reference(x, wt), reps=3, warmup=1)
            library_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), reps=20)
            bound_ms, bound_by = conv_bound_ms(b, h, w, cin, cout, dtype)
            rows.append(dict(name=name, shape=[b, h, w, cin, cout], ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err))
            log(f"[kernels] {name:12s} {str((b, h, w, cin, cout)):26s} bf16 "
                f"max_abs_err {err:.3g} ok; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.conv2d {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"roofline {bound_ms / ms:.1%}")
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


def phase_main_path(model, profile_dir=None):
    images = smooth_images(1, BATCH, HW)
    images_u8 = np.round(images * 255).astype(np.uint8)

    pred = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    pred.predict_array(images[:1])  # warm-up: cuDNN picks its algorithms here
    torch.cuda.synchronize()

    conv3x3_nhwc.launches = 0
    masks = pred.predict_array(images)
    masks_u8 = pred.predict_array(images_u8)
    launches = {"conv3x3_nhwc": conv3x3_nhwc.launches}
    per_forward = len(MAIN_CONVS)
    if launches["conv3x3_nhwc"] != 2 * per_forward:
        raise RuntimeError(f"conv3x3_nhwc launched {launches['conv3x3_nhwc']} times in two "
                           f"forwards, want {2 * per_forward}")
    check_masks(masks, (BATCH, HW, HW))
    check_masks(masks_u8, (BATCH, HW, HW))
    log(f"[main] unet_s bf16 predict_array (8, 512, 512) float + uint8: "
        f"conv3x3_nhwc launches {launches['conv3x3_nhwc']} ({per_forward} per forward); "
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
        fwd_ms = time_ms(lambda: pred.model(x).argmax(-1), reps=20)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler table of the bf16 forward to DIR")
    args = ap.parse_args(argv)

    smi = phase_device()
    phase_build()
    rows, max_err = phase_kernels()
    model = build_model(seed=MODEL_SEED)
    phase_small_reference(model)
    launches, main = phase_main_path(model, args.profile)

    main_rows = [r for r in rows if r["name"] != "ragged"]
    kernel = {
        "name": "conv3x3_nhwc",
        "route": "cuda",
        "source": "unet_medical_image_contour_segmentation_torch/csrc/conv3x3.cu",
        "replaces": "unet_medical_image_contour_segmentation_tpu/ops/pallas_conv.py:133",
        "launches": launches["conv3x3_nhwc"],
        "max_abs_err": max_err,
        # per unet_s forward: the sum over the main path's shapes
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
    }
    log(f"[main] {json.dumps(main)}")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
