"""Inference: preprocess -> forward -> back-resize -> argmax -> post-process.

The dense path of the JAX package's ``engine/predict.py:Predictor``: BN is
folded into the convs once at construction (which also stores the 3x3
weights packed in the compute dtype), images run through the model in
batches under ``torch.inference_mode()``, logits go back to the requested
size by a bilinear resize with ``align_corners=False``, and the argmax takes
the first of equal maxima (``torch.argmax``'s documented rule, the rule of
the JAX package's ``losses/s2d_fused.py:argmax_class_major``).  uint8 images
upload raw and are normalised on the device: /255 only when the image's max
exceeds 1, as ``BasicDataset.preprocess`` does on the host.

Tiled and int8 serving, data-parallel serving and exported-program serving
are not ported yet.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..data.dataset import BasicDataset
from ..device import resolve_device
from ..models.fold_bn import fold_bn
from ..ops.resize import bilinear_resize
from ..pipeline.post_process import postprocess_mask

__all__ = ["Predictor", "mask_to_image", "collect_image_files"]

log = logging.getLogger(__name__)


def mask_to_image(mask: np.ndarray):
    """{0,1,2} -> {0,128,255} PIL image."""
    from PIL import Image

    vis = np.zeros_like(mask, dtype=np.uint8)
    vis[mask == 1] = 128
    vis[mask == 2] = 255
    return Image.fromarray(vis)


def collect_image_files(input_dir: str) -> List[str]:
    """Recursive png/jpg/jpeg walk, sorted."""
    files = []
    for root, _, names in os.walk(input_dir):
        for name in names:
            if name.lower().endswith((".png", ".jpg", ".jpeg")):
                files.append(os.path.join(root, name))
    return sorted(files)


def _norm_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 (B, ...) -> f32, each image /255 iff its max exceeds 1."""
    xf = x.float()
    mx = xf.amax(dim=tuple(range(1, x.dim())), keepdim=True)
    return xf / torch.where(mx > 1, 255.0, 1.0)


class Predictor:
    """Batched predictor for a fixed UNet.

    ``device`` defaults to ``cuda`` (raising when there is no card);
    ``compute_dtype`` defaults to the model's own.  Every BatchNorm is folded
    into its conv (exact in eval mode) on a copy of the model.
    """

    def __init__(self, model: nn.Module, *, device: Optional[Union[str, torch.device]] = None,
                 compute_dtype: Optional[torch.dtype] = None, batch_size: int = 8):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.n_classes = model.n_classes
        cd = model.compute_dtype if compute_dtype is None else compute_dtype
        net = fold_bn(model, cd)
        net.compute_dtype = cd
        self.model = net.to(self.device)

    @torch.inference_mode()
    def _forward(self, images: np.ndarray, out_hw: Tuple[int, int]) -> torch.Tensor:
        """One batch -> (B, outH, outW) int32 class map, left on the device."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        x = _norm_uint8(x) if x.dtype == torch.uint8 else x.float()
        logits = self.model(x)
        if tuple(logits.shape[1:3]) != tuple(out_hw):
            logits = bilinear_resize(logits, out_hw[0], out_hw[1], align_corners=False)
        if self.n_classes == 1:
            return (torch.sigmoid(logits[..., 0]) > 0.5).int()
        return logits.argmax(dim=-1).int()

    def predict_array(self, images: np.ndarray,
                      out_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """images (B, H, W[, C]) float or uint8 -> (B, outH, outW) int32 classes."""
        images = np.asarray(images)
        out_hw = tuple(out_hw or images.shape[1:3])
        preds = [self._forward(images[i:i + self.batch_size], out_hw).cpu().numpy()
                 for i in range(0, len(images), self.batch_size)]
        return np.concatenate(preds)

    def predict_image(self, img, postprocess: bool = True) -> np.ndarray:
        """One PIL image -> {0,1,2} mask at its own size."""
        arr = BasicDataset.preprocess(None, img, scale=1, is_mask=False)
        pred = self.predict_array(arr[None], out_hw=(img.size[1], img.size[0]))[0]
        if postprocess:
            pred = postprocess_mask(pred.astype(np.uint8))
        return pred

    def predict_paths(
        self,
        in_files: Iterable[str],
        output_dir: Optional[str] = None,
        postprocess: bool = True,
        save: bool = True,
        overwrite_suffix: str = ".png",
        fast_transfer: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Predict image files in batches of one size; returns {path: mask}.

        ``fast_transfer=True`` uploads raw uint8 pixels and normalises them
        on the device (a quarter of the bytes; argmax parity with the host
        normalisation).  Decoding and post-processing run in thread pools
        beside the device work.
        """
        from PIL import Image

        in_files = list(in_files)

        def load(path):
            try:
                img = Image.open(path).convert("L")
                if fast_transfer:
                    return path, np.asarray(img)[..., None]
                return path, BasicDataset.preprocess(None, img, scale=1, is_mask=False)
            except (OSError, ValueError):
                log.exception("Failed to open %s", path)
                return path, None

        by_size: Dict[Tuple[int, int], List[Tuple[str, np.ndarray]]] = {}
        with ThreadPoolExecutor(max_workers=8) as loader:
            for path, arr in loader.map(load, in_files):
                if arr is not None:
                    by_size.setdefault(arr.shape[:2], []).append((path, arr))

        results: Dict[str, np.ndarray] = {}

        def host_post(path: str, pred: np.ndarray) -> None:
            if postprocess:
                pred = postprocess_mask(pred.astype(np.uint8))
            results[path] = pred
            if not save:
                return
            if output_dir is None:
                out_path = os.path.splitext(path)[0] + overwrite_suffix
            else:
                os.makedirs(output_dir, exist_ok=True)
                base = os.path.splitext(os.path.basename(path))[0]
                out_path = os.path.join(output_dir, base + overwrite_suffix)
            if out_path.lower().endswith(".png"):
                mask_to_image(pred).save(out_path, compress_level=1)
            else:
                mask_to_image(pred).save(out_path)

        def post_chunk(chunk, preds_device: torch.Tensor) -> None:
            for (path, _), pred in zip(chunk, preds_device.cpu().numpy()):
                host_post(path, pred)

        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = []
            for size, items in by_size.items():
                for i in range(0, len(items), self.batch_size):
                    chunk = items[i:i + self.batch_size]
                    batch = np.stack([a for _, a in chunk])
                    # the device->host copy and post-processing overlap the
                    # next batch's forward
                    futures.append(pool.submit(post_chunk, chunk, self._forward(batch, size)))
            for f in futures:
                f.result()
        return results
