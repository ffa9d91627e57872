"""Serving traffic, a closed loop: one client calls
``Predictor.predict_array`` on ``batch`` uint8 slices at a time and sends the
next call when the class maps of the last are on the host.

Set-up makes the slices and the weights from the seed on the device, builds
the ``Predictor`` (bf16, BN folded by the port; ``quantize=True`` for the
control, calibrated on the pool's first 4 slices) and warms it up on the
pool's own batches.  The window cycles the pool of ``pool`` distinct slices
in order.  ``serve_slices_per_s`` counts the slices of every call issued
in the window over the time until the last of them returned;
``serve_p95_ms`` is the 95th percentile of every call's latency (call to
numpy class map), which the per-layer metric ``latency_p95_ms.interactive``
reports.  A call that raises counts as failed and as missing.

Read: the class maps of the first pass over the pool (every slice once)
and of ``sample_extra`` further calls drawn from the seed (a reservoir over
the window), against the plain reference's f32 logits of the same slices,
computed after the window with the predictor freed.  A served class's gap
is the amount by which the reference's logit of that class lies below its
best: ``mean_logit_gap`` is the mean over every pixel compared,
``worst_logit_gap`` the largest, ``mismatch_pct`` the share of pixels with
a gap.  The cell file names the readings compared and their limits.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import harness, trace, traffic

__all__ = ["KEYS", "run"]

# the keys of a traffic file this driver reads, and nothing else: a file
# that sets another is refused, since nothing here would honour it
KEYS = {"driver", "slices", "pool", "batch", "warmup_calls", "sample_extra", "trace_calls",
        "trace_detail_calls"}
_REF_BLOCK = 8   # slices a reference forward takes at once
_CALIBRATE = 4   # slices the weights' BN statistics are set on


def run(r: harness.Run) -> None:
    from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor

    spec, dev, mix = r.spec, r.device, r.spec.traffic
    r.stage("imported")
    ref = harness.reference(spec)
    b, pool = mix["batch"], mix["pool"]
    images, _ = traffic.synth_slices(spec.slices, pool, r.seed, dev)
    host = images.cpu().numpy()
    r.stage("slices")
    sd = harness.weights(r, ref.normalize_uint8(images[:_CALIBRATE]))
    del images
    r.stage("weights")
    pred = Predictor(harness.port_model(spec, sd, dev), device=dev, batch_size=b,
                     quantize=r.control)
    if r.control:
        pred.calibrate(host[:4])
    r.stage("predictor")
    calls = [host[i:i + b] for i in range(0, pool, b)]
    for i in range(mix["warmup_calls"]):
        pred.predict_array(calls[i % len(calls)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    rng = np.random.default_rng(traffic.seed_words(r.seed, 2))
    first = len(calls)
    kept = {}             # call index -> class maps
    extra = []            # reservoir of (call index, class maps)
    latencies, done = [], []
    n = 0
    r.t_window = t0 = time.perf_counter()
    deadline = t0 + r.seconds
    while True:
        t = time.perf_counter()
        if t >= deadline and n > 0:
            break
        r.attempted += 1
        try:
            out = pred.predict_array(calls[n % len(calls)])
        except Exception as e:  # a failed call is counted, the window goes on
            r.failed += 1
            r.notes.setdefault("first_failure", repr(e))
            n += 1
            continue
        done.append(time.perf_counter())
        latencies.append(done[-1] - t)
        r.slices += len(out)
        if n < first:
            kept[n] = out
        elif len(extra) < mix["sample_extra"]:
            extra.append((n, out))
        else:
            j = int(rng.integers(0, n - first + 1))
            if j < mix["sample_extra"]:
                extra[j] = (n, out)
        n += 1
    t1 = time.perf_counter()
    r.window_s = t1 - t0
    r.end_to_end["serve_slices_per_s"] = r.slices / r.window_s
    if latencies:
        r.end_to_end["serve_p95_ms"] = 1e3 * float(np.percentile(latencies, 95))
        r.notes["latency_ms_p50_p90_p95_p99_max"] = [
            round(1e3 * float(q), 4) for q in np.percentile(latencies, [50, 90, 95, 99, 100])]
    r.notes["window"] = f"{n} calls, {r.slices} slices, {r.window_s:.3f} s"
    r.notes["calls_per_second"] = np.bincount(
        (np.asarray(done) - t0).astype(int), minlength=math.ceil(r.window_s)).tolist()

    if r.trace:
        r.profile = trace.measure(dev, lambda i: pred.predict_array(calls[(n + i) % len(calls)]),
                                  mix["trace_calls"], mix["trace_detail_calls"])
        r.notes["trace"] = trace.describe(r.profile)
        r.notes["trace_pace"] = trace.pace(r.profile, r.window_s, n)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del pred
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept.update(extra)
    _compare(r, ref, sd, host, calls, kept, b)


def _compare(r, ref, sd, host, calls, kept, b) -> None:
    """Judge every kept call's class maps against the reference's logits."""
    dev = r.device
    by_slice = {}         # pool slice -> list of served class maps
    for idx, out in kept.items():
        start = (idx % len(calls)) * b
        for k in range(len(out)):
            by_slice.setdefault(start + k, []).append(out[k])
    worst, wrong, total, gap_sum = 0.0, 0, 0, 0.0
    edges = torch.tensor([0.0, 0.0025, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 1e9],
                         device=dev)
    margins = torch.zeros(len(edges) - 1, dtype=torch.float64, device=dev)
    flips = torch.zeros_like(margins)
    order = sorted(by_slice)
    with torch.no_grad(), ref.no_tf32():
        for i in range(0, len(order), _REF_BLOCK):
            block = order[i:i + _REF_BLOCK]
            x = torch.from_numpy(host[block]).to(dev)
            logits = ref.forward(sd, r.spec.config, ref.normalize_uint8(x))
            best = logits.max(dim=-1).values
            top2 = logits.topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]
            for j, s in enumerate(block):
                for served in by_slice[s]:
                    c = torch.from_numpy(np.asarray(served)).to(dev).long()
                    if (c.shape != best[j].shape or int(c.min()) < 0
                            or int(c.max()) >= logits.shape[-1]):
                        worst, wrong = float("inf"), wrong + c.numel()
                        continue
                    gap = best[j] - logits[j].gather(-1, c.unsqueeze(-1)).squeeze(-1)
                    worst = max(worst, float(gap.max()))
                    gap_sum += float(gap.double().sum())
                    bucket = torch.bucketize(margin[j], edges, right=True) - 1
                    margins += torch.bincount(bucket.flatten(), minlength=len(margins)).double()
                    flips += torch.bincount(bucket[gap > 0], minlength=len(margins)).double()
                    wrong += int((gap > 0).sum())
                    total += c.numel()
    r.notes["compared"] = f"{len(kept)} calls, {total} pixels"
    r.details.update(margin_edges=edges[:-1].tolist(), margin_counts=margins.tolist(),
                     flip_counts=flips.tolist())
    r.readings.update(worst_logit_gap=worst, mismatch_pct=100.0 * wrong / max(total, 1),
                      mean_logit_gap=gap_sum / total if total else math.inf)
