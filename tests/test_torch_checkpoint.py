"""The port's asynchronous checkpoint save and train_model's periodic saves,
on the CPU, against the synchronous save and the JAX package's
``save_checkpoint_async`` (unet_t from seeded JAX-layout weights, 64x64)."""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from chip_smoke import random_unet_params, rect_batch
from unet_medical_image_contour_segmentation_torch.config import TrainConfig
from unet_medical_image_contour_segmentation_torch.engine import checkpoint as TC
from unet_medical_image_contour_segmentation_torch.engine.optim import (
    RMSpropConfig,
    opt_state_to_jax,
)
from unet_medical_image_contour_segmentation_torch.engine.train import (
    make_train_step,
    train_model,
)
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet_t
from unet_medical_image_contour_segmentation_tpu.engine import checkpoint as JC

WIDTHS_T = (8, 16, 32, 64, 128)
LR = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stepped(seed=0, steps=1):
    """unet_t from seeded JAX weights and its RMSprop after ``steps`` steps."""
    params, bn_state = random_unet_params(seed, widths=WIDTHS_T)
    model = unet_t()
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=LR))
    for i in range(steps):
        step({k: torch.from_numpy(v) for k, v in rect_batch(50 + i, 2, 64, 64).items()}, LR)
    return model, step


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_file(a, b):
    a, b = _arrays(a), _arrays(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_async_file_equals_the_sync_one(tmp_path):
    model, step = _stepped()
    kw = dict(step=step.step, mask_values=[0, 128, 255], extra={"epoch": 1},
              optimizer=step.optimizer)
    TC.save_checkpoint(str(tmp_path / "sync.npz"), model, **kw)
    fut = TC.save_checkpoint_async(str(tmp_path / "async.npz"), model, **kw)
    assert fut.result(timeout=60) is None
    _assert_same_file(tmp_path / "sync.npz", tmp_path / "async.npz")
    ck = TC.load_checkpoint(str(tmp_path / "async.npz"))
    assert ck["step"] == 1 and ck["extra"] == {"epoch": 1}
    assert ck["opt_state"]["square_avg"]["outc"]["w"].shape == (1, 1, 8, 3)


def test_jax_reads_the_async_file_as_its_own_async_save(tmp_path):
    """The same weights and RMSprop state carried to the JAX layout and saved
    by JAX's save_checkpoint_async: JAX's load_checkpoint reads both alike."""
    model, step = _stepped(seed=1, steps=2)
    TC.save_checkpoint_async(str(tmp_path / "port.npz"), model, step=2, mask_values=[0, 1, 2],
                             optimizer=step.optimizer).result(timeout=60)
    params, bn_state, _ = params_from_state_dict(model.state_dict())
    JC.save_checkpoint_async(str(tmp_path / "jax.npz"), params, bn_state,
                             opt_state_to_jax(model, step.optimizer), step=2,
                             mask_values=[0, 1, 2]).result(timeout=60)
    ours, theirs = (JC.load_checkpoint(str(tmp_path / f)) for f in ("port.npz", "jax.npz"))
    assert ours["step"] == theirs["step"] == 2
    assert ours["mask_values"] == theirs["mask_values"] and ours["extra"] == theirs["extra"]
    for group in ("params", "bn_state", "opt_state"):
        a, b = ours[group], theirs[group]
        assert jax.tree.structure(a) == jax.tree.structure(b), group
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_a_step_after_the_call_leaves_the_file_pre_step(tmp_path):
    """The snapshot is a copy: a step taken once the call has returned, and
    before the worker writes, does not reach the file (CPU tensors are the
    trap: their ``.cpu()`` shares the storage the step updates in place)."""
    model, step = _stepped(seed=2)
    TC.save_checkpoint(str(tmp_path / "pre.npz"), model, step=1, optimizer=step.optimizer)
    gate = threading.Event()
    with ThreadPoolExecutor(max_workers=1) as worker:
        worker.submit(gate.wait, 60)  # the write queues behind this
        fut = TC.save_checkpoint_async(str(tmp_path / "async.npz"), model, step=1,
                                       optimizer=step.optimizer, executor=worker)
        step({k: torch.from_numpy(v) for k, v in rect_batch(60, 2, 64, 64).items()}, LR)
        TC.save_checkpoint(str(tmp_path / "post.npz"), model, step=1,
                           optimizer=step.optimizer)
        assert not fut.done()
        gate.set()
        fut.result(timeout=60)
    _assert_same_file(tmp_path / "pre.npz", tmp_path / "async.npz")
    pre, post = _arrays(tmp_path / "pre.npz"), _arrays(tmp_path / "post.npz")
    for key in ("params//outc//w", "opt_state//square_avg//outc//w",
                "bn_state//inc//bn1//mean"):
        assert not np.array_equal(pre[key], post[key]), key


def test_async_pth_and_its_errors(tmp_path):
    """A reference .pth goes through the same snapshot; a UNet++ .pth is
    refused on the caller's thread, as by save_checkpoint."""
    from unet_medical_image_contour_segmentation_torch.models.unet_nested import unet_pp_s

    model, _ = _stepped(seed=3)
    TC.save_checkpoint(str(tmp_path / "sync.pth"), model, mask_values=[0, 128, 255])
    TC.save_checkpoint_async(str(tmp_path / "async.pth"), model,
                             mask_values=[0, 128, 255]).result(timeout=60)
    a, b = (torch.load(tmp_path / f, weights_only=False) for f in ("sync.pth", "async.pth"))
    assert sorted(a) == sorted(b) and a["mask_values"] == b["mask_values"] == [0, 128, 255]
    assert all(torch.equal(a[k], b[k]) for k in a if k != "mask_values")
    with pytest.raises(ValueError, match="reference UNet"):
        TC.save_checkpoint_async(str(tmp_path / "pp.pth"), unet_pp_s())


class _Arrays:
    mask_values = [0, 128, 255]

    def __init__(self, n, seed, hw=32):
        rng = np.random.default_rng(seed)
        self.images = rng.random((n, hw, hw, 1), dtype=np.float32)
        self.masks = rng.integers(0, 3, (n, hw, hw)).astype(np.int32)

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, i):
        return {"image": self.images[i], "mask": self.masks[i]}


def _cfg(tmp_path, **kw):
    return TrainConfig(model="unet_t", epochs=2, batch_size=2, learning_rate=LR, amp=False,
                       num_workers=1, dir_checkpoint=str(tmp_path / "ckpts"),
                       checkpoint_every=1, checkpoint_after_frac=0.0, log_every=0,
                       progress=False, save_val_predictions=False, val_postprocess=False,
                       **kw)


def _slow_writes(monkeypatch, order, fail=None):
    """Record the order of the writes, each 0.2 s late; ``fail`` raises in
    the write of that file."""
    real = TC._write

    def write(path, *args):
        threading.Event().wait(0.2)
        order.append(str(path).rsplit("/", 1)[-1])
        if fail is not None and str(path).endswith(fail):
            raise OSError(f"disk full: {path}")
        real(path, *args)

    monkeypatch.setattr(TC, "_write", write)


def test_train_model_writes_its_checkpoints_in_order_before_returning(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    order = []
    _slow_writes(monkeypatch, order)
    result = train_model(_cfg(tmp_path), train_set=_Arrays(4, 1), val_set=_Arrays(2, 2),
                         device="cpu")
    assert order == ["checkpoint_epoch1.npz", "checkpoint_epoch2.npz", "model_epoch2.npz"]
    first, second = (TC.load_checkpoint(str(tmp_path / "ckpts" / f"checkpoint_epoch{e}.npz"))
                     for e in (1, 2))
    assert (first["step"], second["step"], result.step) == (2, 4, 4)
    # the last periodic save and the final one hold the same state
    _assert_same_file(tmp_path / "ckpts" / "checkpoint_epoch2.npz", tmp_path / "model_epoch2.npz")


def test_train_model_raises_a_failed_checkpoint_write(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    order = []
    _slow_writes(monkeypatch, order, fail="checkpoint_epoch1.npz")
    with pytest.raises(OSError, match="disk full"):
        train_model(_cfg(tmp_path), train_set=_Arrays(4, 1), val_set=_Arrays(2, 2),
                    device="cpu")
    # the second save still ran, in order; the final one never started
    assert order == ["checkpoint_epoch1.npz", "checkpoint_epoch2.npz"]
    assert not (tmp_path / "model_epoch2.npz").exists()
