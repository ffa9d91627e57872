"""Host-side dataset, the port's copy of the JAX package's ``data/dataset.py``.

Same behaviour as the reference's BasicDataset: id scan, parallel mask-value
scan, 4x rotation augmentation (original + 90/180/270 with expand), PIL
NEAREST/BICUBIC scale resize, mask value map {255->2, 128->1, 0->0}, /255
image normalisation; samples come out channel-last, ``{"image": (H, W, 1)
float32, "mask": (H, W) int32}``.  PIL is imported where it is used, so the
package imports on machines without it.

Two optional caches of decoded samples, as the JAX package's (the decode and
the bicubic resize are deterministic per index, so both give the same
pixels):

* ``cache_bytes > 0``: a RAM cache, filled until its byte budget is spent
  and never evicted (access is cyclic per epoch, so eviction would churn);
  epochs from the second on skip the decode.  A lock keeps the budget exact
  under the loader's threads.
* ``disk_cache_dir``: one ``.npz`` per (id, rotation, scale), written
  atomically and read back only while the source files' mtimes equal the
  ones stored beside the pixels (a stale or unreadable entry is decoded and
  written again), so it also speeds up the first epoch and a new run.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from os import listdir
from os.path import isfile, join, splitext
from pathlib import Path
from typing import Dict

import numpy as np

__all__ = ["BasicDataset", "CarvanaDataset", "load_image", "unique_mask_values"]

log = logging.getLogger(__name__)


def load_image(filename):
    """npy / torch-tensor / image file -> PIL image."""
    from PIL import Image

    ext = splitext(str(filename))[1]
    if ext == ".npy":
        return Image.fromarray(np.load(filename))
    if ext in (".pt", ".pth"):
        import torch

        return Image.fromarray(torch.load(filename, weights_only=False).numpy())
    return Image.open(filename)


def unique_mask_values(idx: str, mask_dir: Path, mask_suffix: str):
    mask_file = list(Path(mask_dir).glob(idx + mask_suffix + ".*"))[0]
    mask = np.asarray(load_image(mask_file))
    if mask.ndim == 2:
        return np.unique(mask)
    if mask.ndim == 3:
        return np.unique(mask.reshape(-1, mask.shape[-1]), axis=0)
    raise ValueError(f"mask arrays must be rank 2 or 3, got rank {mask.ndim}")


class BasicDataset:
    """Image/mask pairs (``<id>.*`` in ``images_dir``, ``<id><mask_suffix>.*``
    in ``mask_dir``) with optional 4x rotation augmentation."""

    def __init__(self, images_dir, mask_dir, scale: float = 1.0, mask_suffix: str = "_mask",
                 augment: bool = True, cache_bytes: int = 0, disk_cache_dir=None):
        self.images_dir = Path(images_dir)
        self.mask_dir = Path(mask_dir)
        if not 0 < scale <= 1:
            raise ValueError(f"scale must lie in (0, 1], got {scale}")
        self.scale = scale
        self.mask_suffix = mask_suffix
        self.augment = augment
        self._disk_cache_dir = Path(disk_cache_dir) if disk_cache_dir else None
        if self._disk_cache_dir is not None:
            self._disk_cache_dir.mkdir(parents=True, exist_ok=True)
        self._cache = {} if cache_bytes > 0 else None
        self._cache_budget = int(cache_bytes)
        self._cache_used = 0
        self._cache_lock = threading.Lock()

        self.ids = [splitext(f)[0] for f in listdir(images_dir)
                    if isfile(join(images_dir, f)) and not f.startswith(".")]
        if not self.ids:
            raise RuntimeError(f"image directory {images_dir} contains no usable files")
        log.info("dataset ready: %d ids under %s", len(self.ids), images_dir)

        with ThreadPoolExecutor() as ex:
            unique = list(ex.map(
                lambda i: unique_mask_values(i, self.mask_dir, self.mask_suffix), self.ids))
        self.mask_values = list(sorted(np.unique(np.concatenate(unique), axis=0).tolist()))

    def __len__(self) -> int:
        return len(self.ids) * (4 if self.augment else 1)

    @staticmethod
    def preprocess(mask_values, pil_img, scale: float, is_mask: bool):
        """Resize and value-map (mask) or normalise (image) one PIL image.

        Images come back channel-last (H, W, C) float32, /255 when any pixel
        exceeds 1; masks (H, W) int8 with {255: 2, 128: 1, 0: 0}.
        """
        from PIL import Image

        w, h = pil_img.size
        new_w, new_h = int(scale * w), int(scale * h)
        if new_w <= 0 or new_h <= 0:
            raise ValueError(f"scale {scale} collapses a {w}x{h} image to zero pixels")
        pil_img = pil_img.resize((new_w, new_h),
                                 resample=Image.NEAREST if is_mask else Image.BICUBIC)
        img = np.asarray(pil_img)

        if is_mask:
            mask = np.zeros((new_h, new_w), dtype=np.int8)
            mask[img == 255] = 2  # target contour
            mask[img == 128] = 1  # background
            mask[img == 0] = 0    # shadow/ghost
            return mask

        if img.ndim == 2:
            img = img[..., np.newaxis]
        if (img > 1).any():
            img = img.astype(np.float32) / 255.0
        return np.ascontiguousarray(img, dtype=np.float32)

    @staticmethod
    def rotate_image_and_mask(img, mask, angle: int):
        return img.rotate(angle, expand=True), mask.rotate(angle, expand=True)

    def sample_name(self, idx: int) -> str:
        """The id of the image that sample ``idx`` comes from (each image
        gives 4 samples under ``augment``)."""
        return self.ids[idx // 4 if self.augment else idx]

    def __getstate__(self) -> dict:
        """Pickled for a spawned data-parallel rank: without the lock, and
        with an empty RAM cache of the same budget."""
        state = dict(self.__dict__, _cache_lock=None, _cache_used=0)
        if state["_cache"] is not None:
            state["_cache"] = {}
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state, _cache_lock=threading.Lock())

    def _disk_cache_load(self, path: Path, img_file: Path, mask_file: Path):
        """The cached sample, or None for a missing, stale or unreadable entry."""
        try:
            with np.load(path) as z:
                if (float(z["img_mtime"]) != img_file.stat().st_mtime
                        or float(z["mask_mtime"]) != mask_file.stat().st_mtime):
                    return None  # a source changed since the entry was written
                return {"image": z["image"], "mask": z["mask"]}
        except (OSError, KeyError, ValueError, EOFError):
            return None

    def _disk_cache_store(self, path: Path, sample, img_file: Path, mask_file: Path) -> None:
        # through a file handle (np.savez appends ".npz" to a bare name), then
        # renamed into place, so no loader thread reads a partial entry
        tmp = path.with_name(path.name + f".tmp{os.getpid()}.{threading.get_ident()}")
        try:
            with open(tmp, "wb") as f:
                np.savez(f, image=sample["image"], mask=sample["mask"],
                         img_mtime=img_file.stat().st_mtime,
                         mask_mtime=mask_file.stat().st_mtime)
            os.replace(tmp, path)
        except OSError:
            log.warning("disk cache write failed for %s", path, exc_info=True)

    def _ram_cache_insert(self, idx: int, sample):
        if self._cache is not None:
            nb = sample["image"].nbytes + sample["mask"].nbytes
            with self._cache_lock:
                if idx not in self._cache and self._cache_used + nb <= self._cache_budget:
                    self._cache[idx] = sample
                    self._cache_used += nb
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self._cache is not None:
            hit = self._cache.get(idx)
            if hit is not None:
                return hit  # the loader stacks samples into new batches, never mutates
        original_idx = idx // 4 if self.augment else idx
        rotation_idx = idx % 4 if self.augment else 0

        name = self.ids[original_idx]
        mask_file = list(self.mask_dir.glob(name + self.mask_suffix + ".*"))
        img_file = list(self.images_dir.glob(name + ".*"))
        if len(img_file) != 1:
            raise ValueError(f"expected exactly one image for id {name!r}, got {img_file}")
        if len(mask_file) != 1:
            raise ValueError(f"expected exactly one mask for id {name!r}, got {mask_file}")

        cache_path = None
        if self._disk_cache_dir is not None:
            cache_path = self._disk_cache_dir / f"{name}.r{rotation_idx}.s{self.scale:g}.npz"
            sample = self._disk_cache_load(cache_path, img_file[0], mask_file[0])
            if sample is not None:
                return self._ram_cache_insert(idx, sample)

        mask = load_image(mask_file[0])
        img = load_image(img_file[0])
        if img.size != mask.size:
            raise ValueError(f"size mismatch for {name!r}: image {img.size} vs mask {mask.size}")

        if self.augment and rotation_idx > 0:
            img, mask = self.rotate_image_and_mask(img, mask, (90, 180, 270)[rotation_idx - 1])

        img_a = self.preprocess(self.mask_values, img, self.scale, is_mask=False)
        mask_a = self.preprocess(self.mask_values, mask, self.scale, is_mask=True)
        if not np.all((mask_a >= 0) & (mask_a <= 2)):
            raise ValueError("mask holds values outside the class range {0,1,2}")
        sample = {"image": img_a, "mask": mask_a.astype(np.int32)}
        if cache_path is not None:
            self._disk_cache_store(cache_path, sample, img_file[0], mask_file[0])
        return self._ram_cache_insert(idx, sample)


class CarvanaDataset(BasicDataset):
    """The reference's Carvana layout: masks named ``<id>_mask.*``."""

    def __init__(self, images_dir, mask_dir, scale: float = 1, augment: bool = True):
        super().__init__(images_dir, mask_dir, scale, mask_suffix="_mask", augment=augment)
