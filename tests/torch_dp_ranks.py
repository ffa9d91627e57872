"""Rank bodies for the port's data-parallel tests (tests/test_torch_parallel.py).

Each spawned rank imports this module, which imports torch and the port but
no JAX, joins a gloo group through a ``file://`` rendezvous in the test's
``tmp_path`` (so that parallel test workers never race for a port), runs
one body on its rows of a global batch given as numpy arrays, and saves
what the body returns for the test process to compare.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unet_medical_image_contour_segmentation_torch.engine.evaluate import evaluate
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.train import TrainStep
from unet_medical_image_contour_segmentation_torch.losses import boundary as TB
from unet_medical_image_contour_segmentation_torch.losses import compound as TL
from unet_medical_image_contour_segmentation_torch.losses import dice as TD
from unet_medical_image_contour_segmentation_torch.models.torch_compat import state_dict_from_jax
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_torch.ops.nn import batch_norm
from unet_medical_image_contour_segmentation_torch.parallel import (
    batch_slice,
    make_data_group,
    make_parallel_eval_step,
    make_parallel_train_step,
    replicate,
)

LR = 1e-4


def _entry(body, rank, n, rendezvous, args, out, join):
    torch.set_num_threads(1)
    try:
        if join:
            dist.init_process_group("gloo", init_method=rendezvous, world_size=n, rank=rank)
            result = body(rank, make_data_group(), *args)
            dist.destroy_process_group()
        else:
            result = body(rank, rendezvous, *args)
        torch.save(result, f"{out}.{rank}")
    except BaseException:
        with open(f"{out}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(body, args, tmp_path, n=2, timeout=120, join=True):
    """``body(rank, group, *args)`` on ``n`` spawned gloo ranks -> their
    results, rank order; fails with a rank's traceback, or after
    ``timeout`` seconds.  With ``join=False`` the ranks join no group and
    the body gets the rendezvous URL in place of the group."""
    ctx = mp.get_context("spawn")
    out = str(tmp_path / body.__name__)
    procs = [ctx.Process(target=_entry, args=(body, r, n, f"file://{out}.rendezvous", args,
                                                 out, join)) for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(f"{out}.{r}.err").read() for r in range(n) if os.path.exists(f"{out}.{r}.err")]
    assert not errors, errors[0]
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(n)]


def rows(rank, group, x):
    return x[batch_slice(len(x), group)]


def bn_and_losses(rank, group, data):
    """Cross-replica BN (output, running statistics, and the gradients of
    sum(y * g) over the group's batch) and every loss term with its
    gradient with respect to this rank's logits."""
    x = torch.from_numpy(rows(rank, group, data["x"])).requires_grad_()
    g = torch.from_numpy(rows(rank, group, data["g"]))
    scale = torch.from_numpy(data["scale"]).requires_grad_()
    bias = torch.from_numpy(data["bias"]).requires_grad_()
    y, (mean, var) = batch_norm(x, scale, bias, torch.from_numpy(data["rm"]),
                                torch.from_numpy(data["rv"]), train=True, group=group)
    (y * g).sum().backward()
    out = {"y": y.detach(), "mean": mean, "var": var, "dx": x.grad, "dscale": scale.grad,
           "dbias": bias.grad}

    targets = torch.from_numpy(rows(rank, group, data["targets"]))
    for name, fn in {
        "ce": lambda z: TL.cross_entropy(z, targets, group),
        "bce": lambda z: TL.bce_with_logits(z[..., 0], targets.float() // 2, group),
        "dice": lambda z: TD.dice_loss(torch.softmax(z, -1),
                                       torch.nn.functional.one_hot(targets.long(), 3).float(),
                                       multiclass=True, group=group),
        "boundary": lambda z: TB.boundary_loss(z, (targets * 127.5).float(), edge_width=4,
                                               group=group),
        "multiclass": lambda z: TL.compute_loss(z, targets, TL.LossConfig(), group)[0],
        "binary": lambda z: TL.compute_loss(z[..., :1], targets,
                                            TL.LossConfig(n_classes=1), group)[0],
    }.items():
        z = torch.from_numpy(rows(rank, group, data["logits"])).requires_grad_()
        value = fn(z)
        if value.requires_grad:
            value.backward()
        out[name] = (value.item(), None if z.grad is None else z.grad)
    return out


def cc_in_step(rank, group, logits, targets):
    """The binary loss with the in-step connected-component penalty on this
    rank's rows: its metrics (the penalty the ranks' mean)."""
    cfg = TL.LossConfig(n_classes=1, connected_component=True)
    return TL.compute_loss(torch.from_numpy(rows(rank, group, logits)),
                           torch.from_numpy(rows(rank, group, targets)), cfg, group)[1]


def _model(name, n_classes, params, bn_state):
    model = get_model(name, n_classes=n_classes)
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    return model


def train_step(rank, group, name, n_classes, params, bn_state, batch, cc):
    """One data-parallel step on this rank's rows of ``batch``: metrics,
    gradients (after the average and the clip), parameters and buffers."""
    model = _model(name, n_classes, params, bn_state)
    cfg = TL.LossConfig(n_classes=n_classes, connected_component=cc, cc_emit_probs=cc)
    step = make_parallel_train_step(model, cfg, RMSpropConfig(learning_rate=LR), group)
    replicate(model, step.optimizer, group)
    metrics = step({k: torch.from_numpy(rows(rank, group, v)) for k, v in batch.items()}, LR)
    return {"metrics": metrics,
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "state": {k: v.detach() for k, v in model.state_dict().items()}}


def plain_and_group_steps(rank, group, name, params_by_classes, batch):
    """For each criterion (``params_by_classes``: {n_classes: (params,
    bn_state)}), the plain step and the data-parallel step over ``group``
    (of one rank) from the same weights on the same batch: metrics,
    gradients, parameters and buffers of both."""
    out = {}
    for n_classes, (params, bn_state) in params_by_classes.items():
        for label, g in (("plain", None), ("group", group)):
            model = _model(name, n_classes, params, bn_state)
            step = TrainStep(model, TL.LossConfig(n_classes=n_classes),
                             RMSpropConfig(learning_rate=LR), group=g)
            metrics = step({k: torch.from_numpy(v) for k, v in batch.items()}, LR)
            out[n_classes, label] = {
                "metrics": metrics, "grads": {k: p.grad for k, p in model.named_parameters()},
                "state": {k: v.detach() for k, v in model.state_dict().items()}}
    return out


def dp_evaluate(rank, group, name, params, bn_state, samples, batch_size):
    """evaluate() over a ragged loader, each batch sharded over the group."""
    from unet_medical_image_contour_segmentation_torch.data.loader import DataLoader

    model = _model(name, 3, params, bn_state)
    loader = DataLoader(samples, batch_size, shuffle=False, num_workers=1)
    return evaluate(model, loader, device="cpu", postprocess=False,
                    eval_step=make_parallel_eval_step(model, group),
                    batch_pad=dist.get_world_size(group))


def train_in_group(rank, group, cfg, samples, val, out):
    """A rank that the caller launched: train_model in a process that has
    joined the group (num_devices None takes the group's size)."""
    from unet_medical_image_contour_segmentation_torch.engine.train import train_model
    from unet_medical_image_contour_segmentation_torch.models.unet import unet_t

    os.chdir(out)
    torch.manual_seed(0)
    step = train_model(cfg, model=unet_t(), train_set=samples, val_set=val, device="cpu")
    return {k: v.detach() for k, v in step.model.state_dict().items()}


def train_cli_rank(rank, rendezvous, argv, out):
    """One process of a multi-host run of the train CLI: rank ``rank`` of 2,
    joined through ``--coordinator-address`` (a rendezvous URL here)."""
    from unet_medical_image_contour_segmentation_torch.cli import train as train_cli

    os.chdir(out)
    rc = train_cli.main([*argv, "--distributed", "--coordinator-address", rendezvous,
                         "--num-processes", "2", "--process-id", str(rank)])
    return rc, dist.is_initialized()


def np_samples(n, hw, seed):
    """A list of ``{"image", "mask"}`` samples (a dataset in the BasicDataset
    protocol that pickles into spawned ranks)."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((hw, hw, 1), dtype=np.float32),
             "mask": rng.integers(0, 3, (hw, hw)).astype(np.int32)} for _ in range(n)]
