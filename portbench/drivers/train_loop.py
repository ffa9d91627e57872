"""Training traffic: ``TrainStep`` fed by ``prefetch_to_device``, as
``engine/train.py:_train`` takes its steps: each batch through the prefetch
(``size`` batches ahead on a side stream), one step, and the step's
metrics fetched ``nan_check_every`` steps behind with a finite-loss check.

Set-up makes ``pool_batches`` batches of (batch, H, W, 1) f32 images and
int32 masks from the seed on the device, keeps them on the host, builds the
model and its ``TrainStep`` from the seeded weights, and drives that same
object through its first ``checked_steps`` steps by the window's own feed
and call, on the pool's first batches (rows that all differ), then through
``warmup_steps`` more.  It reads
the loss of each, the norm of each parameter's first gradient as RMSprop
took it (from its ``square_avg`` after one step), and the norm of each
parameter's change and of each BN running statistic's after the last of
them, before the next step moves them.
The window then goes on with the same feed and the same object.
``train_slices_per_s`` counts the slices of every step issued in the window
over the time until the last one's metrics were fetched.

Read after the window, with the program freed, against the plain
reference's f32 steps from the same weights on the same batches:
``loss_gap``, the worst step's |loss - reference| / |reference|;
``grad_norm_gap``, ``change_gap`` and ``bn_stats_gap`` (the running
statistics' change), the worst tensor's |norm - reference's norm| over the
larger of the reference's norm of that tensor and of the median one
(``.median``: the median tensor's; ``.total``: the gap of the norm over all
of them).
Parameters whose reference gradient is under a thousandth of the median
one's are left out of the change: RMSprop moves them by round-off.  The
cell file names the readings compared and their limits.

The control (``Run.control``) puts the reference's step in float8 in the
program's place.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import harness, trace, traffic

__all__ = ["KEYS", "run"]

# the keys of a traffic file this driver reads, and nothing else: a file
# that sets another is refused, since nothing here would honour it (the
# loss is always cross entropy plus Dice, the optimizer always RMSprop)
KEYS = {"driver", "slices", "pool_batches", "batch", "prefetch_size", "nan_check_every",
        "checked_steps", "warmup_steps", "trace_steps", "trace_detail_steps", "loss.dice_epsilon",
        "optimizer.learning_rate", "optimizer.alpha", "optimizer.eps",
        "optimizer.weight_decay", "optimizer.momentum", "gradient_clipping"}

_SMALL_GRAD = 1e-3
_CALIBRATE = 4   # slices the weights' BN statistics are set on


class _ControlStep:
    """The reference's step in float8, with ``TrainStep``'s call."""

    def __init__(self, ref, sd, cfg, mix):
        self.trainer = ref.Trainer(sd, cfg, mix, quant="fp8")
        self.optimizer = self.trainer.optimizer

    def named_parameters(self):
        return self.trainer.params.items()

    def named_buffers(self):
        return self.trainer.state.items()

    def __call__(self, batch, lr):
        return {"loss": self.trainer.step(batch["image"], batch["mask"])}


def _named(step) -> dict:
    model = getattr(step, "model", step)
    return dict(model.named_parameters())


def _bn_stats(step, names) -> dict:
    model = getattr(step, "model", step)
    buffers = dict(model.named_buffers())
    return {k: buffers[k].detach().float().clone() for k in names}


def _gaps(prog: dict, refs: dict, names) -> dict:
    """|prog - ref| / max(ref, the median ref) of each of ``names``."""
    med = float(np.median([refs[k] for k in names]))
    return {k: abs(prog[k] - refs[k]) / max(refs[k], med) for k in names}


def _norm_readings(r, name: str, prog: dict, refs: dict, names) -> None:
    """The worst leaf's gap (``name``), the median leaf's (``name.median``)
    and the gap of the norm over all of ``names`` (``name.total``)."""
    gaps = _gaps(prog, refs, names)
    leaf = max(gaps, key=gaps.get)
    total = lambda d: float(np.sqrt(sum(d[k] ** 2 for k in names)))  # noqa: E731
    r.notes[f"{name}.worst_leaf"] = f"{leaf} {prog[leaf]!r} against {refs[leaf]!r}"
    r.readings[name] = gaps[leaf]
    r.readings[f"{name}.median"] = float(np.median(list(gaps.values())))
    r.readings[f"{name}.total"] = abs(total(prog) - total(refs)) / total(refs)


def run(r: harness.Run) -> None:
    from unet_medical_image_contour_segmentation_torch.data.loader import prefetch_to_device
    from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
    from unet_medical_image_contour_segmentation_torch.engine.train import TrainStep
    from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig

    spec, dev, mix, cfg = r.spec, r.device, r.spec.traffic, r.spec.config
    r.stage("imported")
    ref = harness.reference(spec)
    b, nb = mix["batch"], mix["pool_batches"]
    images, masks = traffic.synth_slices(spec.slices, b * nb, r.seed, dev)
    x = ref.normalize_uint8(images).unsqueeze(-1)
    pool = [{"image": x[i * b:(i + 1) * b].cpu().numpy(),
             "mask": masks[i * b:(i + 1) * b].to(torch.int32).cpu().numpy()} for i in range(nb)]
    r.stage("slices")
    sd = harness.weights(r, x[:_CALIBRATE])
    del images, masks, x
    r.stage("weights")
    o = mix["optimizer"]
    lr = o["learning_rate"]
    if r.control:
        step = _ControlStep(ref, sd, cfg, mix)
    else:
        step = TrainStep(harness.port_model(spec, sd, dev), LossConfig(n_classes=cfg["n_classes"]),
                         RMSpropConfig(learning_rate=lr, alpha=o["alpha"], eps=o["eps"],
                                       weight_decay=o["weight_decay"], momentum=o["momentum"]),
                         mix["gradient_clipping"])

    def cycle():
        i = 0
        while True:
            yield pool[i % nb]
            i += 1

    r.stage("train_step")
    feed = prefetch_to_device(cycle(), dev, size=mix["prefetch_size"])
    named = _named(step)
    losses, grads = [], None
    for s in range(mix["checked_steps"]):
        losses.append(float(step(next(feed), lr)["loss"]))
        if grads is None:
            state = step.optimizer.state
            grads = {k: float((state[p]["square_avg"].sum() / (1.0 - o["alpha"])).sqrt())
                     for k, p in named.items()}
    change = {k: float((p.detach().float() - sd[k]).norm()) for k, p in named.items()}
    bn_names = ref.bn_stats(sd)
    bn_change = {k: float((v - sd[k]).norm()) for k, v in _bn_stats(step, bn_names).items()}

    pending = []

    def drain():
        if not pending:
            return
        keys = list(pending[0])
        rows = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in pending]).cpu().numpy()
        bad = int((~np.isfinite(rows[:, keys.index("loss")])).sum())
        if bad:
            r.failed += bad
            r.notes.setdefault("first_failure", "a non-finite loss")
        pending.clear()

    done = []

    def one_step(waits, issues):
        ta = time.perf_counter()
        batch = next(feed)
        tb = time.perf_counter()
        metrics = step(batch, lr)
        tc = time.perf_counter()
        waits.append(tb - ta)
        issues.append(tc - tb)
        if len(pending) >= mix["nan_check_every"]:
            drain()
        pending.append(metrics)
        done.append(time.perf_counter())

    for _ in range(mix["warmup_steps"]):
        one_step([], [])
    drain()
    done.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    waits, issues = [], []
    r.t_window = t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() < t0 + r.seconds:
        one_step(waits, issues)
        n += 1
    drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    r.window_s = time.perf_counter() - t0
    r.attempted, r.slices = n, n * b
    r.spans["prefetch_wait_s"], r.spans["step_issue_s"] = waits, issues
    r.end_to_end["train_slices_per_s"] = r.slices / r.window_s
    r.notes["window"] = f"{n} steps, {r.slices} slices, {r.window_s:.3f} s"
    # a step's metrics are fetched when the next step is issued
    r.notes["steps_per_second"] = np.bincount(
        (np.asarray(done[:n]) - t0).astype(int), minlength=math.ceil(r.window_s)).tolist()
    if r.trace:
        r.profile = trace.measure(dev, lambda i: one_step([], []), mix["trace_steps"],
                                  mix["trace_detail_steps"], drain)
        r.notes["trace"] = trace.describe(r.profile)
        r.notes["trace_pace"] = trace.pace(r.profile, r.window_s, n)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    feed.close()
    del step, named, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    batches = [(torch.from_numpy(p["image"]).to(dev), torch.from_numpy(p["mask"]).to(dev))
               for p in pool[:mix["checked_steps"]]]
    want = ref.train_steps(sd, cfg, batches, mix)
    steps_gap = [abs(a - w) / abs(w) for a, w in zip(losses, want["losses"])]
    r.readings["loss_gap"] = max(steps_gap)
    r.details.update(grads=grads, want_grads=want["grad_norms"], change=change,
                     want_change=want["change_norms"], losses=losses, want_losses=want["losses"],
                     bn_change=bn_change, want_bn_change=want["bn_change_norms"])
    _norm_readings(r, "grad_norm_gap", grads, want["grad_norms"], list(grads))
    med = float(np.median(list(want["grad_norms"].values())))
    moved = [k for k, g in want["grad_norms"].items() if g >= _SMALL_GRAD * med]
    r.notes["change_left_out"] = sorted(set(change) - set(moved))
    _norm_readings(r, "change_gap", change, want["change_norms"], moved)
    _norm_readings(r, "bn_stats_gap", bn_change, want["bn_change_norms"], bn_names)
