"""Inference: preprocess -> forward -> back-resize -> argmax -> post-process.

The dense and tiled paths of the JAX package's ``engine/predict.py:Predictor``,
for the UNet family, UNet++ and YOLOv8-seg (and TransUNet, served dense in
float from ``models/fold_bn.py:fold_transunet``):
BN is folded into the convs once at construction (which also stores the 3x3
weights packed in the compute dtype; a model with no DoubleConv to fold,
YOLOv8-seg, serves with live BN in eval mode, as JAX's does), images run
through the model in
batches under ``torch.inference_mode()``, logits go back to the requested
size by a bilinear resize with ``align_corners=False``, and the argmax takes
the first of equal maxima (``torch.argmax``'s documented rule, the rule of
the JAX package's ``losses/s2d_fused.py:argmax_class_major``).  uint8 images
upload raw and are normalised on the device: /255 only when the image's max
exceeds 1, as ``BasicDataset.preprocess`` does on the host.

Images above ``tile_threshold`` pixels (1536² by default) are served in
overlapping tiles: the image is zero-padded by ``tile_halo`` around the tile
grid, each ``tile + 2*halo`` window runs the forward, and only its central
``tile`` x ``tile`` core is kept.  This is not the dense function: the dense
forward zero-pads every conv's activation at the image border, the tiled one
zero-pads the image and computes the halo, so within about a receptive field
of the border the two can differ (in the interior they agree).  The port
follows the JAX package here, tile for tile.

``quantize=True`` serves in int8 (``models/quantize.py``): the activation
scales calibrate on the first batch predicted (at most 4 images, H and W cut
to multiples of the model's ``hw_divisor``, 16 for the UNets, 2^(depth-1)
for UNet++, 32 for YOLOv8-seg; a batch whose cut is under 32 pixels serves
in float and waits for the next) or explicitly (:meth:`Predictor.calibrate`,
:meth:`Predictor.load_calibration`), on the forward of an f32 BN fold (the
CBS fold for YOLOv8-seg, ``fold_bn.py:fold_yolo``), and the weights
quantise per output channel from that fold.  Every DoubleConv conv runs on
the int8 kernel (``kernels/conv3x3_int8.py``); for YOLOv8-seg the proto
head's three 3x3 convs do (``build_qparams_yolo``'s default scope, as
JAX's Predictor), with the SiLU epilogue.  A batch goes to the float program
instead where the JAX package's rules send it there: H or W not a multiple
of ``hw_divisor``, or a dense batch smaller than ``INT8_MIN_BATCH`` of its
architecture.

:class:`ExportedPredictor` serves a ``torch.export`` program
(``engine/export.py``, the ``.pt2`` counterpart of the JAX package's
StableHLO): the same dense and tiled paths around the program's forward.

Data-parallel serving (``Predictor(num_devices=N)`` or ``devices=[...]``,
the JAX package's ``num_devices``): one replica of the served weights (and
of the int8 qparams) per device, the first device the home of the results.
A dense batch pads to a multiple of the replicas by repeating its last
image, each replica serves its rows (uploaded to its device), and the class
maps come back to the home device cropped to the batch, as JAX's
``_shard_batch`` does.  The tiled path shards the tiles: its groups of
``tile_batch`` windows go to the replicas in turn.  JAX instead rounds the
group up to a multiple of the devices and splits each group over them; on
an H100, cuDNN's bf16 convs round a forward of 4 windows of 704² apart from
one of 8 (10169 pixels of a 2048² scan differ, PERF.md), so whole groups
keep each forward the single device's and the classes exactly its.
``ExportedPredictor`` stays on one device, as JAX's ``StableHLOPredictor``
does.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.dataset import BasicDataset
from ..device import resolve_device
from ..models.fold_bn import fold_for_quantize, serving_copy
from ..models.quantize import apply_int8, build_for, calibrate_amax, folded_tree
from ..ops.resize import bilinear_resize
from ..pipeline.post_process import postprocess_mask
from ..utils.profiling import span

__all__ = ["Predictor", "ExportedPredictor", "mask_to_image", "collect_image_files",
           "replica_devices"]

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


def replica_devices(device: Optional[Union[str, torch.device]] = None,
                    num_devices: Optional[int] = None,
                    devices: Optional[Sequence[Union[str, torch.device]]] = None
                    ) -> List[torch.device]:
    """The devices of the serving replicas: ``devices`` as given (a device
    may repeat), else ``num_devices`` (None: 1) of them: ``cuda:0..N-1`` for
    a CUDA ``device`` (raising where the host has fewer cards), N times the
    CPU for the CPU."""
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out or (num_devices is not None and num_devices != len(out)):
            raise ValueError(f"num_devices {num_devices} does not match devices {devices}")
        return out
    n = 1 if num_devices is None else num_devices
    if n < 1:
        raise ValueError(f"num_devices must be at least 1, not {n}")
    base = resolve_device(device)
    if n == 1:
        return [base]
    if base.type == "cuda":
        if n > torch.cuda.device_count():
            raise ValueError(f"num_devices {n} exceeds the {torch.cuda.device_count()} CUDA "
                             f"devices of this host")
        return [torch.device("cuda", i) for i in range(n)]
    return [base] * n


def _tree_to(tree, device: torch.device):
    """Every tensor of a nested dict / list / tuple moved to ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree


def _fetch_classes(classes: torch.Tensor, out: np.ndarray,
                   staging: Dict[torch.device, torch.Tensor]) -> None:
    """Copy a class map into ``out``, an int32 host array of its shape.

    A map on a CUDA device (route ``"pinned"``) is copied into
    ``staging[device]``, a pinned buffer allocated on first use and again
    only when a map needs more bytes; the copy is queued on the current
    stream and only its event is waited for.  (A copy into fresh pageable
    memory stages through CUDA's own pinned buffer and faults the new pages
    in, every call.)  A map on the host (route ``"host"``) is read where it
    lies.  Either way one host pass widens it into ``out``, so nothing the
    caller keeps aliases the buffer: torch's ``copy_``, which splits the cast
    over the intra-op threads (numpy's ``copyto`` takes one: 1.46 ms against
    0.43 for an (8, 512²) map on the H100 machine's host, PERF.md).  The
    caller holds the lock that guards ``staging``.
    ``_fetch_classes.calls_by_route`` counts the maps by route."""
    with span("predict.fetch") as s:
        nbytes = classes.numel() * classes.element_size()
        if classes.device.type == "cuda":
            route = "pinned"
            buf = staging.get(classes.device)
            if buf is None or buf.numel() < nbytes:
                buf = staging[classes.device] = torch.empty(nbytes, dtype=torch.uint8,
                                                            pin_memory=True)
            host = buf[:nbytes].view(classes.dtype).view(classes.shape)
            host.copy_(classes, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(classes.device))
            done.synchronize()
        else:
            route = "host"
            host = classes
        torch.from_numpy(out).copy_(host)
        _fetch_classes.calls_by_route[route] += 1
        s["route"], s["bytes"] = route, nbytes


_fetch_classes.calls_by_route = Counter()


class _Serving:
    """The dense and tiled serving paths (see the module docstring) around a
    forward that a subclass gives: :meth:`_logits` maps (N, H, W, C) float
    on replica ``r``'s device to f32 logits, :meth:`_dense_logits` is the
    dense path's forward (the same by default), :meth:`_classes` the class
    map, and :meth:`_prepare` sees every batch before it is served.
    ``devices`` lists the replicas' devices, the first the home device."""

    # dense-path pixel budget: above it, predict tiles the image; 0 = never
    TILE_THRESHOLD = 1536 * 1536
    # tiles stacked into the batch dimension of each tiled forward
    tile_batch = 8
    # tile=None takes the largest candidate whose grid has at least
    # AUTO_TILE_MIN_TILES tiles: a bigger tile computes a smaller share of
    # halo (1216²/1024² = 1.41x the core's pixels against 704²/512² = 1.89x),
    # a small grid wastes duplicate tiles in its last group.  The rule is the
    # JAX package's; the card's tile-512 and tile-1024 times at 4096² are in
    # PERF.md (chip_smoke.py's tiled phase).
    AUTO_TILES = (512, 1024)
    AUTO_TILE_MIN_TILES = 8
    # False: one forward per tile, stitched on the host (the reference the
    # device grid is tested against)
    tile_on_device = True

    def __init__(self, device: Optional[Union[str, torch.device]], batch_size: int,
                 tile: Optional[int], tile_halo: int, tile_threshold: Optional[int]):
        self.device = resolve_device(device)
        self.devices = [self.device]
        self.batch_size = batch_size
        self.tile = tile
        self.tile_halo = tile_halo
        self.tile_threshold = self.TILE_THRESHOLD if tile_threshold is None else tile_threshold
        # predict_array's pinned staging buffer per device (_fetch_classes),
        # and the lock that keeps two threads from sharing it at once
        self._staging: Dict[torch.device, torch.Tensor] = {}
        self._fetch_lock = threading.Lock()

    def _logits(self, x: torch.Tensor, r: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def _dense_logits(self, x: torch.Tensor, gate_batch: int, r: int = 0) -> torch.Tensor:
        return self._logits(x, r)

    def _on_replicas(self, images: np.ndarray,
                     fn: Callable[[int, torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``fn(r, rows)`` over the replicas: the host ``images`` padded to a
        multiple of their number by repeating the last image, each replica's
        rows uploaded to its device, the results gathered on the home device
        and cropped to the batch (JAX's ``_shard_batch``)."""
        k, n = len(self.devices), images.shape[0]
        if k > 1:
            images = np.concatenate([images, np.repeat(images[-1:], -n % k, axis=0)])
        outs = []
        for r, (dev, part) in enumerate(zip(self.devices, np.array_split(images, k))):
            with span("predict.upload"):
                x = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
            outs.append(fn(r, x))
        if k == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])[:n]

    def _classes(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) logits -> (B, H, W) classes: the argmax, or for one
        output channel (a binary model) sigmoid > 0.5, as the evaluate path
        does.  uint8 for at most 256 classes, else int32: the map crosses
        to the host in a quarter of the bytes, and :meth:`predict_array`
        widens it there."""
        dtype = torch.uint8 if logits.shape[-1] <= 256 else torch.int32
        if logits.shape[-1] == 1:
            return (torch.sigmoid(logits[..., 0]) > 0.5).to(dtype)
        return logits.argmax(dim=-1).to(dtype)

    def _prepare(self, images: np.ndarray) -> None:
        pass

    @torch.inference_mode()
    def _forward(self, images: np.ndarray, out_hw: Tuple[int, int],
                 gate_batch: int) -> torch.Tensor:
        """One batch -> (B, outH, outW) class map (:meth:`_classes`), left on
        the home device, through :meth:`_dense_logits` with ``gate_batch`` on each
        replica's rows."""

        def serve(r: int, x: torch.Tensor) -> torch.Tensor:
            with span("predict.forward"):
                x = _norm_uint8(x) if x.dtype == torch.uint8 else x.float()
                logits = self._dense_logits(x, gate_batch, r)
                if tuple(logits.shape[1:3]) != tuple(out_hw):
                    logits = bilinear_resize(logits, out_hw[0], out_hw[1], align_corners=False)
                return self._classes(logits)

        return self._on_replicas(images, serve)

    def _use_tiling(self, in_hw, out_hw) -> bool:
        """Tile when the image exceeds the pixel budget and no back-resize is
        asked for (stitched class maps cannot be resized as logits are)."""
        if self.tile_threshold <= 0 or tuple(out_hw) != tuple(in_hw):
            return False
        return in_hw[0] * in_hw[1] > self.tile_threshold

    def _auto_tile(self, h: int, w: int) -> int:
        for t in sorted(self.AUTO_TILES, reverse=True):
            if (-(-h // t)) * (-(-w // t)) >= self.AUTO_TILE_MIN_TILES:
                return t
        return min(self.AUTO_TILES)

    def _tile_core(self, windows: torch.Tensor, tile: int, halo: int, r: int = 0
                   ) -> torch.Tensor:
        """(N, win, win, C) float windows -> (N, tile, tile) classes of their
        central cores (:meth:`_classes`), through :meth:`_logits` at any batch (no int8
        gate) on replica ``r``, returned on the home device."""
        logits = self._logits(windows.to(self.devices[r]), r)
        return self._classes(logits[:, halo:halo + tile, halo:halo + tile]).to(self.device)

    @torch.inference_mode()
    def _tile_grid(self, x: torch.Tensor, tile: int, halo: int) -> torch.Tensor:
        """The device tiled path: (n, h, w, C) image on the device, float or
        uint8 -> (n, h, w) uint8 class map on the device.

        Pads once, then walks the tile offsets in groups of ``tpb`` =
        ``tile_batch`` (at most the grid size), the last group padded with
        duplicates of the last tile so that every forward has one batch
        shape (a duplicate rewrites its core with the same classes).  Each
        group's windows stack into the batch dimension, (tpb * n, win, win,
        C), and their cores are written into the map; nothing returns to
        the host per tile.  With several replicas the groups go to them in
        turn, so that each forward is the single device's, shape for shape
        (see the module docstring).  uint8 stays uint8 in the padded buffer and each
        window is divided by its image's divisor (zero padding cannot raise
        a uint8 maximum, so the padded and raw maxima agree)."""
        n, h, w, c = x.shape
        ph, pw = -h % tile, -w % tile
        gh, gw = (h + ph) // tile, (w + pw) // tile
        win = tile + 2 * halo
        tpb = min(self.tile_batch, gh * gw)
        offs = [(i * tile, j * tile) for i in range(gh) for j in range(gw)]
        offs += offs[-1:] * (-len(offs) % tpb)
        padded = F.pad(x, (0, 0, halo, halo + pw, halo, halo + ph))
        div = None
        if x.dtype == torch.uint8:
            mx = padded.amax(dim=(1, 2, 3)).float()
            div = torch.where(mx > 1, 255.0, 1.0).view(1, n, 1, 1, 1)
        out = torch.zeros((n, gh * tile, gw * tile), dtype=torch.uint8, device=x.device)
        for g in range(0, len(offs), tpb):
            group = offs[g:g + tpb]
            wins = torch.stack([padded[:, i:i + win, j:j + win] for i, j in group]).float()
            if div is not None:
                wins = wins / div
            pred = self._tile_core(wins.reshape(tpb * n, win, win, c), tile, halo,
                                   (g // tpb) % len(self.devices))
            pred = pred.reshape(tpb, n, tile, tile).to(torch.uint8)
            for t, (i, j) in enumerate(group):
                out[:, i:i + tile, j:j + tile] = pred[t]
        return out[:, :h, :w]

    @torch.inference_mode()
    def _tiled_predict(self, images: np.ndarray) -> torch.Tensor:
        """(n, H, W[, C]) host images -> (n, H, W) class map on the device,
        through the device grid (:meth:`_tile_grid`) or, with
        ``tile_on_device = False``, one forward per tile stitched on the host."""
        n, h, w = images.shape[:3]
        tile = self.tile or self._auto_tile(h, w)
        halo = self.tile_halo
        if images.ndim == 3:
            images = images[..., None]
        if self.tile_on_device:
            x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
            return self._tile_grid(x, tile, halo)
        if images.dtype == np.uint8:
            images = _norm_uint8(torch.from_numpy(images)).numpy()
        ph, pw = -h % tile, -w % tile
        win = tile + 2 * halo
        padded = np.pad(images, ((0, 0), (halo, halo + ph), (halo, halo + pw), (0, 0)))
        pending = []  # every forward is issued before the first core is fetched
        offs = [(i, j) for i in range(0, h + ph, tile) for j in range(0, w + pw, tile)]
        for t, (i, j) in enumerate(offs):
            window = np.ascontiguousarray(padded[:, i:i + win, j:j + win])
            x = torch.from_numpy(window).to(self.device).float()
            pending.append((i, j, self._tile_core(x, tile, halo, t % len(self.devices))))
        out = np.empty((n, h + ph, w + pw), np.int32)
        for i, j, core in pending:
            out[:, i:i + tile, j:j + tile] = core.cpu().numpy()
        return torch.from_numpy(out[:, :h, :w])

    def _predict_device(self, images: np.ndarray, out_hw: Optional[Tuple[int, int]] = None,
                        gate_batch: Optional[int] = None) -> torch.Tensor:
        """One batch of one size -> its class map (B, outH, outW), tiled or
        dense, left where it was computed.  The dense path hands
        ``gate_batch`` (this batch's size when None) to :meth:`_dense_logits`,
        where :class:`Predictor` gates int8 on it."""
        in_hw = tuple(images.shape[1:3])
        out_hw = tuple(out_hw or in_hw)
        self._prepare(images)
        if self._use_tiling(in_hw, out_hw):
            with span("predict.forward"):
                return self._tiled_predict(images)
        return self._forward(images, out_hw, len(images) if gate_batch is None else gate_batch)

    def predict_array(self, images: np.ndarray,
                      out_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """images (B, H, W[, C]) float or uint8 -> (B, outH, outW) int32 classes.

        As the JAX package's ``predict_array``, the whole array decides once
        whether the int8 program serves (its B against ``INT8_MIN_BATCH``)
        and calibrates on its first 4 images; it runs in chunks of
        ``batch_size`` only to bound device memory, each chunk on that one
        program.  (``predict_paths`` gates each batch, as JAX's does.)"""
        images = np.asarray(images)
        starts = range(0, len(images), self.batch_size)
        with span("predict", slices=len(images), chunks=len(starts)):
            self._prepare(images)
            out = np.empty((len(images), *(out_hw or images.shape[1:3])), np.int32)
            for i in starts:
                classes = self._predict_device(images[i:i + self.batch_size], out_hw,
                                               len(images))
                with self._fetch_lock:
                    _fetch_classes(classes, out[i:i + self.batch_size], self._staging)
            return out

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
            preds = preds_device.cpu().numpy().astype(np.int32, copy=False)
            for (path, _), pred in zip(chunk, preds):
                host_post(path, pred)

        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = []
            for items in by_size.values():
                for i in range(0, len(items), self.batch_size):
                    chunk = items[i:i + self.batch_size]
                    batch = np.stack([a for _, a in chunk])
                    # the device->host copy and post-processing overlap the
                    # next batch's forward
                    futures.append(pool.submit(post_chunk, chunk, self._predict_device(batch)))
            for f in futures:
                f.result()
        return results

class Predictor(_Serving):
    """Batched predictor for a fixed UNet, UNet++ or YOLOv8-seg.

    ``device`` defaults to ``cuda`` (raising when there is no card);
    ``compute_dtype`` defaults to the model's own.  Every DoubleConv's
    BatchNorm is folded into its conv (exact in eval mode) on a copy of the
    model; a model without one (YOLOv8-seg) serves an eval copy with live
    BN.  ``tile``,
    ``tile_halo`` and ``tile_threshold`` set the tiled path (see the module
    docstring): ``tile=None`` picks the tile per image (:meth:`_auto_tile`),
    ``tile_threshold=None`` takes ``TILE_THRESHOLD`` and 0 never tiles.
    ``quantize=True`` serves in int8 (see the module docstring); the
    calibration is a small JSON of per-tap amax floats, in the JAX package's
    format (:meth:`save_calibration`, :meth:`load_calibration`).
    ``num_devices`` / ``devices`` serve data-parallel (see the module
    docstring and :func:`replica_devices`); ``device`` is then the kind of
    device (``cuda`` by default).
    """

    # the smallest dense batch served in int8, per architecture (the JAX
    # package's map); smaller batches serve the float program.  The tiled
    # path is not gated: it runs tile_batch windows a forward.  The card's
    # int8 / bf16 times at b = 1..8 are in PERF.md (chip_smoke.py's sweep).
    INT8_MIN_BATCH: Dict[str, int] = {"unet_sa": 4}

    def __init__(self, model: nn.Module, *, device: Optional[Union[str, torch.device]] = None,
                 compute_dtype: Optional[torch.dtype] = None, batch_size: int = 8,
                 tile: Optional[int] = None, tile_halo: int = 96,
                 tile_threshold: Optional[int] = None, quantize: bool = False,
                 num_devices: Optional[int] = None,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        with span("setup.predictor"):
            devices = replica_devices(device, num_devices, devices)
            super().__init__(devices[0], batch_size, tile, tile_halo, tile_threshold)
            self.devices = devices
            # the spatial divisor of the int8 program and of the calibration crop
            self.hw_divisor = model.hw_divisor
            # a model with position embeddings (TransUNet) serves dense, in float,
            # at every size
            if hasattr(model, "img_size"):
                if quantize or tile is not None or (tile_threshold or 0) > 0:
                    raise ValueError(f"{model.name} serves dense images in float only: no "
                                     f"int8 (quantize=True) and no tiling")
                self.tile_threshold = 0
            cd = model.compute_dtype if compute_dtype is None else compute_dtype
            net = serving_copy(model, cd)
            net.compute_dtype = cd
            self.model = net.to(self.device)
            # one copy of the served weights per distinct device
            copies = {self.device: self.model}
            for d in devices[1:]:
                if d not in copies:
                    copies[d] = copy.deepcopy(self.model).to(d)
            self._replicas = [copies[d] for d in devices]
            self._qreplicas: List[dict] = []
            self.compute_dtype = cd
            self.arch = getattr(model, "name", "")
            self.quantize = quantize
            self._qparams: Optional[dict] = None
            self._amax: Optional[Dict[str, float]] = None
            # calibration and quantisation read an f32 fold on the device (the
            # JAX package's folded params); for the UNets its forward in the
            # compute dtype is the serving fold's, for YOLOv8-seg the CBS fold
            self._qfolded = (folded_tree(fold_for_quantize(model).to(self.device))
                             if quantize else None)

    # -- int8 serving (models/quantize.py) ----------------------------------

    def calibrate(self, images: np.ndarray) -> None:
        """Calibrate the int8 activation scales on (B, H, W[, C]) float or
        uint8 images, cut to multiples of ``hw_divisor`` (per-tensor scales do
        not depend on the cut): the f32 fold's forward in the compute dtype."""
        x = torch.from_numpy(np.ascontiguousarray(images))
        x = _norm_uint8(x) if x.dtype == torch.uint8 else x.float()
        div = self.hw_divisor
        hc, wc = x.shape[1] // div * div, x.shape[2] // div * div
        if hc < div or wc < div:
            raise ValueError(f"calibration images too small: {tuple(x.shape)}")
        if self._qfolded is None:
            raise ValueError("int8 serving needs a Predictor built with quantize=True")
        x = x[:, :hc, :wc].contiguous().to(self.device)
        self._set_amax(calibrate_amax(self._qfolded, x, self.compute_dtype))

    def _set_amax(self, amax: Dict[str, float]) -> None:
        """Build the int8 qparams on the device from calibration amaxes."""
        if self._qfolded is None:
            raise ValueError("int8 serving needs a Predictor built with quantize=True")
        self._qparams = build_for(self._qfolded)(self._qfolded, amax, device=self.device)
        copies = {self.device: self._qparams}
        for d in self.devices[1:]:
            if d not in copies:
                copies[d] = _tree_to(self._qparams, d)
        self._qreplicas = [copies[d] for d in self.devices]
        self._amax = dict(amax)

    def save_calibration(self, path: str) -> None:
        """Write the calibration as JSON ({tap: amax}); the int8 weights
        rebuild from it deterministically."""
        if self._amax is None:
            raise ValueError("not calibrated yet: call calibrate() or predict one batch first")
        with open(path, "w") as f:
            json.dump(self._amax, f, indent=1, sort_keys=True)

    def load_calibration(self, path: str) -> None:
        """Load a calibration written by :meth:`save_calibration` (or by the
        JAX package's)."""
        with open(path) as f:
            self._set_amax(json.load(f))

    def _prepare(self, images: np.ndarray) -> None:
        """First-batch auto-calibration on at most 4 images; a batch whose
        ``hw_divisor``-multiple cut is under 32 pixels (or one divisor; the
        bottleneck would vanish) is skipped and serves in float."""
        if not self.quantize or self._qparams is not None:
            return
        div = self.hw_divisor
        if min(images.shape[1] // div, images.shape[2] // div) * div >= max(32, div):
            self.calibrate(images[:4])

    def _int8_min_batch(self) -> int:
        return self.INT8_MIN_BATCH.get(self.arch, 1)

    def _int8_ok(self, h: int, w: int) -> bool:
        """Calibrated, and H and W multiples of ``hw_divisor`` (else the float
        program)."""
        return (self._qparams is not None and h % self.hw_divisor == 0
                and w % self.hw_divisor == 0)

    def _logits(self, x: torch.Tensor, r: int = 0) -> torch.Tensor:
        """(N, H, W, C) float on replica ``r``'s device -> f32 logits, int8
        where :meth:`_int8_ok`, else the float fold."""
        if self._int8_ok(x.shape[1], x.shape[2]):
            return apply_int8(self._qreplicas[r], x, self.compute_dtype)
        return self._replicas[r](x)

    def _dense_logits(self, x: torch.Tensor, gate_batch: int, r: int = 0) -> torch.Tensor:
        """The dense forward: :meth:`_logits` when ``gate_batch`` (the whole
        batch, not a replica's share) reaches ``INT8_MIN_BATCH``, else the
        float fold."""
        if gate_batch >= self._int8_min_batch():
            return self._logits(x, r)
        return self._replicas[r](x)


class ExportedPredictor(_Serving):
    """The serving paths of :class:`Predictor` around an exported program
    (``.pt2`` bytes, a path, or a loaded ExportedProgram), the counterpart
    of the JAX package's ``StableHLOPredictor``: BN folding, the compute
    dtype and int8 were fixed at export time and the program maps (B, H, W,
    C) f32 images to logits.  uint8 images are normalised on the host (the
    program's input is f32), the classes are the argmax of the logits, or
    sigmoid > 0.5 for a binary program (JAX's ``StableHLOPredictor`` takes
    the argmax of one channel, so 0 everywhere), and the tiled path uses a fixed tile of 512 by default (an int8
    program has one static window size: ``tile + 2 * tile_halo``).  The
    program runs on the device it was exported on, which ``device`` must
    name."""

    def __init__(self, exported, *, device: Optional[Union[str, torch.device]] = None,
                 batch_size: int = 8, tile: Optional[int] = 512, tile_halo: int = 96,
                 tile_threshold: Optional[int] = None):
        from .export import load_exported

        super().__init__(device, batch_size, tile, tile_halo, tile_threshold)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        program = load_exported(exported) if isinstance(exported, (bytes, bytearray, str)) \
            else exported
        self.model = program.module()
        held = {t.device for t in self.model.state_dict().values()}
        if held and held != {self.device}:
            raise ValueError(f"the program holds its weights on {sorted(map(str, held))}; "
                             f"it serves there, not on {self.device}")

    @classmethod
    def from_file(cls, path: str, **kw) -> "ExportedPredictor":
        with open(path, "rb") as f:
            return cls(f.read(), **kw)

    def _logits(self, x: torch.Tensor, r: int = 0) -> torch.Tensor:
        return self.model(x if x.dim() == 4 else x.unsqueeze(-1)).float()

    def _predict_device(self, images: np.ndarray, out_hw: Optional[Tuple[int, int]] = None,
                        gate_batch: Optional[int] = None) -> torch.Tensor:
        if images.dtype == np.uint8:
            images = _norm_uint8(torch.from_numpy(images)).numpy()
        return super()._predict_device(images, out_hw, gate_batch)
