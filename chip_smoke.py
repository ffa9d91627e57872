#!/usr/bin/env python
"""Build and run the PyTorch/CUDA port on one NVIDIA GPU, checking every kernel.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile DIR   # also write torch.profiler tables of
                                          # the bf16 and int8 predict forwards and
                                          # the train step

Phases, in order; any failure exits nonzero before the last line:
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel source with nvcc (all at once) and prints
     the build seconds and ptxas's registers / shared memory / spills; the
     libraries must lie in the checkout's build/torch_kernels/, and, beside
     that build, a copy of the package laid out as installed in a
     site-packages builds its 3x3 kernel into its HOME's
     ~/.cache/umics/torch_kernels (utils/compile_cache.py) and loads it;
  3. kernels vs plain: each kernel at the shapes the main paths give it (the
     dense forward's, the tiled forward's windows of 704² and 1216², a
     ragged one, and, checked but not timed, the train variants' own convs,
     tile 512's groups of 8 windows on one 4096² image, the int8
     calibration forward's batch of 4 and the exported program's 1024x768
     image), bf16 (the tensor-core kernel) and f32 (the CUDA-core
     kernel), against its plain PyTorch version, with kernel / plain (dense
     shapes) / library times and the bound from the bytes and operations;
     every timed call takes the next of enough copies of its input to
     exceed the 50 MB L2, and a roofline share above 105% fails the run;
     then the folded convs' one-pass bias + ReLU (csrc/bias_relu.cu):
     bit for bit torch.relu(y + b) at every shape unet_s's served forward
     gives it at (8, 512²), bf16 and f32, and timed at unet's and unet_s's
     widest outputs, (8, 512², 64) and (8, 512², 16) bf16, against its byte
     bound and that plain pair, with the host's µs a call of each;
  4. backward vs plain: the 3x3 conv's dx (the same kernel on the output
     gradient with the rotated weight) and dw (cuDNN's weight gradient) at
     the training shapes of every trained model (the bilinear unet_s's
     up3.conv2 is 32->16), bf16 and f32, against autograd through the plain
     version, with dx kernel / plain / cuDNN dgrad / dw times at unet_s's;
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
     step time, slices/s and peak memory; then the slice's main path: two
     epochs of train_model on an in-memory dataset of 512x512 slices,
     without tqdm, PIL or cv2, with a checkpoint after each epoch written
     asynchronously (7 + 7 launches a step and 7 a validation forward;
     checkpoint_epoch2.npz must equal model_epoch2.npz array for array); the
     seconds the training thread spends in save_checkpoint against
     save_checkpoint_async for the full unet with its RMSprop state (the
     files must be equal), and the full unet's train_model with its saves
     asynchronous against synchronous, in turns; prefetch_to_device feeding 24 seeded (8, 512,
     512, 1) f32 batches and their masks to a consumer with a fixed device
     busy-wait a batch (every yielded batch must equal its host batch, also
     when the consumer zeroes and drops it after use), its ms a batch
     against the consumer alone, the copy alone and the two in line on one
     stream; then the rest of the reference's training, each at (8, 512, 512) bf16:
     A1 the binary criterion (BCE + Dice + 0.25 * boundary) on unet_s with
     one output channel: phase 6's f32 card-vs-CPU step, 7 + 7 launches a
     step, a falling loss, the boundary term's device ms and share of the
     step; A2 unet_sa and the bilinear unet_s (launches from the dispatch
     rule over each model's convs, 7 + 7); A3 a remat step against a plain
     one from the same weights and batch (the same loss, gradients within
     phase 6's bounds, bit-equal BN running stats and num_batches_tracked,
     14 forward + 7 dx launches), peak memory of both and of the full unet;
     A4 train_model with --cc-loss (every logged loss = device loss + host
     penalty) and the penalty's host ms;
  8. main path, tiled predict: unet_s bf16 at (2, 2048, 2048) float and
     uint8 (auto tile 512) and (1, 4096, 4096) (auto tile 1024, and 512):
     7 launches per window-group forward, all on the tensor cores; masks
     against f32 tiled masks (>= 99%), against dense masks in the interior
     (>= 99.9% in f32, >= 99% in bf16), and card vs CPU on a small image;
     slices/s, megapixels/s,
     device ms per image, peak memory, dense at 2048² beside it;
  9. main path, pipeline: whether PIL and cv2 import; if so, run_pipeline on
     16 synthetic 1536x1024 RAW scans with an injected unet_s Predictor and
     with the default full unet from a saved .npz (stage directories, labelme
     JSON, seconds per stage, launches); if not, stage 3's device work alone;
 10. int8 kernel vs plain: the int8 conv with its requant / dequant epilogue
     at the 18 unet_s convs at (8, 512, 512), at 16 windows of 704², and at
     the four Up conv1s as split (skip, upsample) inputs at both sizes
     (ReLU), and at yolov8_seg_s's 11 SiLU shapes at (8, 512, 512) (its
     proto head's three convs, and the full scope's bottleneck convs,
     signed int8 and bf16 out), exactly equal to its plain version run on
     the card, launch geometry equal to the Python mirror's; kernel /
     plain / bf16-path / torch._int_mm times and the bound (bytes, or
     operations at the int8 peak);
 11. main path, int8 predict: unet_s int8 (bf16 compute) at (8, 512, 512),
     first-batch calibration, 18 int8 launches and no bf16-kernel launch per
     forward, masks >= 99% equal to f32, device and host times beside bf16;
 12. the INT8_MIN_BATCH sweep: int8 / bf16 device time at b = 1, 2, 4, 8,
     unet_s and unet_sa;
 13. tiled int8: (2, 2048, 2048), launches, >= 99% agreement with bf16 tiled;
 14. the int8 pipeline: run_pipeline --int8 twice on one scales JSON (the
     second run loads it), stage-3 masks equal;
 15. export: B1 unet_s bf16 as a torch.export program (dynamic batch, H and
     W), saved as .pt2, loaded and served by ExportedPredictor at (8, 512,
     512) and at 1024x768 from one program: 7 launches a forward through
     the operator, masks >= 99.9% equal to the live Predictor's, host
     slices/s beside it; B2 the int8 program at 512² from a calibration
     JSON: 18 int8 and no bf16 launch a forward, masks 100% equal to the
     live int8 Predictor's on the same qparams;
 16. UNet++ and YOLOv8-seg at the presets' full widths, seeded random weights
     in the JAX layout: C1 unet_pp_s (3 classes) served by Predictor at (8,
     512, 512) bf16 (12 kernel launches a forward, masks >= 99% of f32,
     slices/s, batch-1 p50, device ms, peak memory), one forward of the full
     unet_pp for its peak memory (no launch), one 2048² scan tiled against
     dense in the interior; C2 unet_pp_s int8 (30 int8 launches, no bf16
     launch, card vs CPU int8 masks >= 99%, device ms against bf16) and its
     int8 .pt2 program (masks 100% of the live int8 Predictor's); C3
     unet_pp_s training (f32 card-vs-CPU step, 20 bf16 steps of 12 + 12
     launches, a falling loss, a remat step bit-equal in BN state to a
     plain one, peak memory both ways); C4 yolov8_seg_s (binary, live BN):
     serving (4 launches a forward), an f32 card-vs-CPU binary step, 20 bf16
     steps of 4 + 4 launches, and a bf16 .pt2 program served at (8, 512,
     512) and 1024x768 (masks >= 99.9% of the live Predictor's); C5
     yolov8_seg_s int8 (bf16 compute): the proto scope through Predictor
     (3 int8 and 2 bf16 launches a forward, card vs CPU int8 masks >=
     99.99%, masks vs f32, device forward int8 against bf16, slices/s,
     batch-1 p50), one full-scope forward (23 int8 launches, none bf16;
     its torch._int_mm route's time and bound), and its int8 .pt2 program (masks
     100% of the live int8 Predictor's);
 17. data parallelism (parallel/), each phase's launches counted: D1 the
     data-parallel train step at world size 1 (NCCL, one process) on unet_s
     at (8, 512, 512) bf16 against the plain step from the same weights,
     bit for bit (both take the BN variance one-pass; cuDNN held to its
     deterministic algorithms), 7 + 7 launches a step, both steps' ms (in turns), peak memory,
     and the all-reduces a step with a lone one's host and device cost; D2
     two ranks on the one card (spawned processes of 4 rows each, gloo:
     whether NCCL takes two ranks on one device is tried first and logged)
     taking one f32 step (TF32 off) of the multiclass and the binary
     criterion against the single process's (8, 512, 512) step (D2_TOL),
     each rank's launches (7 + 7) and launched shapes; D3 data-parallel
     serving, Predictor(devices=["cuda:0", "cuda:0"]): a ragged dense batch
     of 7, one 2048² scan tiled and int8 at (8, 512, 512), masks 100% equal
     to the single-device Predictor's, launches, slices/s beside it;
     then A0, the BN variance formulas: on D1's activations (unet_s bf16 at
     (8, 512, 512)), each of its 18 BNs' largest error of the one-pass
     (JAX's, the port's) and the two-pass formula against an f64 BN, f32
     and rounded to bf16; and S1-S6, spatial parallelism (parallel/spatial.py),
     the ranks spawned on cuda:0 over gloo, each rank's launches equal to
     the plain step's and its launched shapes reported: S1 unet_s at (2,
     1024, 1024) over 2 bands of 512 rows, one f32 step (TF32 off) against
     one process's plain step (S_TOL) with the ranks bit-equal, then bf16
     (reported), step ms on the host clock, CUDA time and peak memory a
     rank beside the plain step's; S2 the bilinear unet_s, unet_sa, the
     binary criterion, remat and unet_pp_s at (2, 512, 512), f32, D2's gate
     (S2_TOL); S3 the 2 x 2 (data, spatial) layout, four ranks, unet_s at
     (4, 512, 512), S1's gate; S4 one 2048² scan through make_spatial_forward
     over 2 ranks against one process's forward, f32 masks 100% equal, bf16
     agreement reported; S5 yolov8_seg_s's binary step at (2, 1024, 1024)
     over 2 bands of 512 rows (its stride-2 convs and SPPF's -inf-filled
     pools on bands), f32 at D2's gate with the ranks bit-equal and 4 + 4
     launches a rank, bf16 reported and timed as S1's; S6 the served
     (live-BN) yolov8_seg_s's forward of one 2048² scan, S4's gates (a
     differing f32 pixel fails the run with its dense logit);
 18. launch shapes: every (B, H, W, Cin, Cout, dtype) at which a counted
     window of phases 5-17 launched the conv3x3 kernel must be one that
     phase 3 or 4 held against the plain version (phases 3 and 4 time S1's
     and S5's band-plus-halo shapes and check S2-S4's and S6's; phase 3
     times YOLO's two shapes that unet_s lacks, 32->32 at 128² and at 512²,
     and checks its exported program's and its calibration's); every shape
     at which one launched the int8 kernel was held against its plain
     version in phase 10, or is held here; so is every (B, H, W, C, dtype)
     at which one launched the one-pass bias + ReLU that phase 3 did not
     hold (each window also counts the pass's launches: 18 a served UNet
     forward, 30 a UNet++ one, none in training, YOLO or int8);
 19. a JSON ``kernels`` line (with per-shape rows and the launches of every
     path, the data-parallel ones included), then the device line and the
     result line.

Imports nothing of JAX.  Reads nothing outside the checkout; the kernels
build into build/torch_kernels/ (writes beyond it go to temporary
directories).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import itertools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
PORT_NAME = "unet_medical_image_contour_segmentation_torch"
sys.path.insert(0, str(REPO))

from unet_medical_image_contour_segmentation_torch import exact_f32  # noqa: E402
from unet_medical_image_contour_segmentation_torch.config import (  # noqa: E402
    PipelineConfig,
    TrainConfig,
)
from unet_medical_image_contour_segmentation_torch.data.loader import (  # noqa: E402
    prefetch_to_device,
)
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
    save_checkpoint_async,
)
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig  # noqa: E402
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor  # noqa: E402
from unet_medical_image_contour_segmentation_torch.engine.train import (  # noqa: E402
    make_train_step,
    train_model,
)
from unet_medical_image_contour_segmentation_torch.kernels import _build  # noqa: E402
from unet_medical_image_contour_segmentation_torch.kernels._build import LAUNCHES  # noqa: E402
from unet_medical_image_contour_segmentation_torch.kernels.bias_relu import (  # noqa: E402
    bias_relu_nhwc,
    bias_relu_nhwc_reference,
)
from unet_medical_image_contour_segmentation_torch.kernels import (  # noqa: E402
    conv3x3 as conv3x3_module,
)
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3 import (  # noqa: E402
    _patches,
    supported,
    conv3x3_nhwc,
    conv3x3_nhwc_dw,
    conv3x3_nhwc_dx,
    conv3x3_nhwc_reference,
    kernel_blocks_per_sm,
    launch_geometry,
    rotate_weight,
)
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3_int8 import (  # noqa: E402
    conv3x3_int8,
    conv3x3_int8_reference,
    kernel_geometry,
)
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3_int8 import (  # noqa: E402
    launch_geometry as launch_int8_geometry,
)
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3_int8 import (  # noqa: E402
    weight_matrix as int8_weight_matrix,
)
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3_int8 import (  # noqa: E402
    pack_weight as pack_int8_weight,
)
from unet_medical_image_contour_segmentation_torch.losses.boundary import (  # noqa: E402
    boundary_loss,
)
from unet_medical_image_contour_segmentation_torch.losses.compound import (  # noqa: E402
    LossConfig,
)
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (  # noqa: E402
    params_from_state_dict,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models import (  # noqa: E402
    blocks as blocks_module,
)
from unet_medical_image_contour_segmentation_torch.models import (  # noqa: E402
    quantize as quantize_module,
)
from unet_medical_image_contour_segmentation_torch.models.fold_bn import (  # noqa: E402
    FoldedDoubleConv,
    serving_copy,
)
from unet_medical_image_contour_segmentation_torch.models.quantize import (  # noqa: E402
    apply_int8,
    build_qparams_yolo,
)
from unet_medical_image_contour_segmentation_torch.models.unet import (  # noqa: E402
    get_model,
    unet,
    unet_s,
    unet_sa,
)
from unet_medical_image_contour_segmentation_torch.ops.nn import BN_EPS, conv2d  # noqa: E402
from unet_medical_image_contour_segmentation_torch.parallel import (  # noqa: E402
    make_data_group,
    make_dp_spatial_mesh,
    make_parallel_train_step,
    make_spatial_forward,
    make_spatial_train_step,
    replicate,
    shard_batch,
)
from unet_medical_image_contour_segmentation_torch.pipeline.post_process import (  # noqa: E402
    postprocess_mask,
)
from unet_medical_image_contour_segmentation_torch.pipeline.seg_main import (  # noqa: E402
    STAGES,
    _build_predictor,
    run_pipeline,
)
from unet_medical_image_contour_segmentation_torch.utils import compile_cache  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

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
# (name, B, H, W, C) of the one-pass bias + ReLU timed on the card: the
# widest folded conv output of unet and of unet_s at (BATCH, HW, HW)
BIAS_RELU_SHAPES = [("unet inc", BATCH, HW, HW, 64), ("unet_s inc", BATCH, HW, HW, 16)]
# launches of the one-pass bias + ReLU a served forward makes: two a
# BN-folded DoubleConv (9 in unet_s and in unet, 15 UNet++ nodes); training,
# YOLOv8-seg's CBS blocks and the int8 forwards make none
UNET_PASSES, PP_PASSES = 18, 30
RAGGED = ("ragged", 1, 37, 53, 24, 40)
# the int8 paths calibrate on the first 4 images of a batch: a bf16 forward
# of MAIN_CONVS at (CALIB_BATCH, HW, HW)
CALIB_BATCH = 4
# the exported program serves one image of this size besides (BATCH, HW, HW)
EXPORT_WIDE = (1024, 768)
# the 18 DoubleConv convs of unet_s, every one int8 on the int8 path: name,
# Cin, Cout, downsampling of the level, and the epilogue's output (int8
# requantises; "float" dequantises to the compute dtype)
INT8_CONVS = [
    ("inc.conv1", 1, 16, 1, "int8"), ("inc.conv2", 16, 16, 1, "int8"),
    ("down1.conv1", 16, 32, 2, "int8"), ("down1.conv2", 32, 32, 2, "int8"),
    ("down2.conv1", 32, 64, 4, "int8"), ("down2.conv2", 64, 64, 4, "int8"),
    ("down3.conv1", 64, 128, 8, "int8"), ("down3.conv2", 128, 128, 8, "int8"),
    ("down4.conv1", 128, 256, 16, "int8"), ("down4.conv2", 256, 256, 16, "float"),
    ("up1.conv1", 256, 128, 8, "int8"), ("up1.conv2", 128, 128, 8, "float"),
    ("up2.conv1", 128, 64, 4, "int8"), ("up2.conv2", 64, 64, 4, "float"),
    ("up3.conv1", 64, 32, 2, "int8"), ("up3.conv2", 32, 32, 2, "float"),
    ("up4.conv1", 32, 16, 1, "int8"), ("up4.conv2", 16, 16, 1, "float"),
]
# the Up convs whose input is the decoder's (skip, upsample) pair: the int8
# forward hands them the two parts as a split input
SPLIT_CONVS = ("up1.conv1", "up2.conv1", "up3.conv1", "up4.conv1")
# yolov8_seg_s's 3x3 stride-1 int8 convs, each with the SiLU epilogue, at
# (BATCH, HW, HW): name, Cin, Cout, downsampling, the epilogue's output, and
# how many a full-scope forward runs (the proto scope runs the p_c convs
# alone).  Each bottleneck's cv1 requantises (signed) and its cv2
# dequantises; n4's and n3's bottlenecks share c2f2's and c2f1's shapes.
YOLO_SILU_CONVS = [
    ("p_c1", 64, 64, 4, "float", 1), ("p_c2", 32, 32, 2, "float", 1),
    ("p_c3", 32, 32, 1, "float", 1),
    ("c2f0.m.cv1", 32, 32, 4, "int8", 1), ("c2f0.m.cv2", 32, 32, 4, "float", 1),
    ("c2f1.m.cv1", 64, 64, 8, "int8", 4), ("c2f1.m.cv2", 64, 64, 8, "float", 4),
    ("c2f2.m.cv1", 128, 128, 16, "int8", 4), ("c2f2.m.cv2", 128, 128, 16, "float", 4),
    ("c2f3.m.cv1", 256, 256, 32, "int8", 1), ("c2f3.m.cv2", 256, 256, 32, "float", 1),
]
YOLO_PROTO_CONVS = ("p_c1", "p_c2", "p_c3")
# the SiLU operands' requant scale: their true-scale values spread about 4
# around 0 (silu_operands), so the signed requant clips at 127 and takes
# SiLU's negative lobe down to about -9
SILU_INV_S = 127 / 4.0
# the tiled unet_s forwards hand the kernel tpb * n windows of tile + 2 * 96
# pixels: 16 of 704² (tile 512 at (2, 2048, 2048)) and 8 of 1216² (tile 1024
# at (1, 4096, 4096)); MAIN_CONVS at each window's levels
HALO = 96
TILED_WINDOWS = [(16, 512 + 2 * HALO), (8, 1024 + 2 * HALO)]
# tile 512 on one 4096² image: groups of 8 windows of 704² (checked, not timed)
TILED_ONE_IMAGE = (8, 512 + 2 * HALO)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# each timed call reads the next of enough input copies to exceed the L2
ROTATE_BYTES = 64 * 2**20
MAX_ROOFLINE = 1.05
SLEEP_HZ = 2.0e9              # above the H100's highest SM clock (1.98 GHz)
QUEUED_ATTEMPTS = 3
MIN_AGREEMENT = 0.99
# tiled vs dense f32 masks (TF32 off), >= HALO from the border.  In bf16 the
# two agreed on 100% of the interior at 2048² but on 99.78% at 4096² on an
# H100 (PERF.md): the convs left to cuDNN run at other shapes in the two
# paths and may take other algorithms, and a bf16 rounding then flips
# near-ties, as between 8 and 2 windows of one size (tests/test_torch_gpu.py);
# bf16 is held to MIN_AGREEMENT there, like bf16 against f32
MIN_INTERIOR_AGREEMENT = 0.999
# exported program vs the live Predictor, the same function in bf16
MIN_EXPORT_AGREEMENT = 0.999
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
    not the host's issue rate, which the host clock times instead; where
    the host took longer than the sleep to issue them (a stall of the
    shared host), they are timed again on the next inputs, and the run
    fails after QUEUED_ATTEMPTS such attempts.  Else the calls run as a
    caller issues them, and the events time both."""
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(i)
    issue_s = (time.perf_counter() - t0) / warmup
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # at most SLEEP_HZ cycles a second, so the sleep lasts at least sleep_s
    sleep_s = 4 * reps * issue_s + 2e-3
    for attempt in range(1, QUEUED_ATTEMPTS + 1):
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
        start.record()
        t0 = time.perf_counter()
        for i in range(reps):  # each attempt on the next inputs, none in the L2
            fn(warmup + (attempt - 1) * reps + i)
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if not queued or host_s <= sleep_s:
            return start.elapsed_time(end) / reps, host_s / reps * 1e3
        # the events then timed the host's issue too: a stall of the shared
        # host; measure again, and give up after QUEUED_ATTEMPTS
        log(f"[time_ms] attempt {attempt}: the host took {host_s:.4f} s to issue {reps} "
            f"calls, longer than the {sleep_s:.4f} s sleep they queued behind")
    raise RuntimeError(f"the host took {host_s:.4f} s to issue {reps} calls, longer than "
                       f"the {sleep_s:.4f} s sleep they queued behind, {QUEUED_ATTEMPTS} times")


def copies(t: torch.Tensor) -> list:
    """``t`` and clones of it, at least 2 and together at least ROTATE_BYTES,
    so that a call on copy i % n finds none of its input in the L2."""
    n = max(2, -(-ROTATE_BYTES // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def int8_operands(seed: int, b: int, h: int, w: int, cin: int, cout: int, device) -> tuple:
    """Seeded operands of conv3x3_int8: int8 x (b, h, w, cin) and packed
    weight over [-127, 127], and f32 mul / badd that give the epilogue's
    f32 values a spread of about 70 around 0, so the requant clips at both
    ends."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))
    mul = rng.uniform(0.5, 1.5, cout) * 60.0 / (np.sqrt(9 * cin) * 73.0 ** 2)
    badd = rng.normal(0.0, 30.0, cout)
    return (x.to(device), pack_int8_weight(wt).to(device),
            torch.from_numpy(mul.astype(np.float32)).to(device),
            torch.from_numpy(badd.astype(np.float32)).to(device))


def silu_operands(seed: int, b: int, h: int, w: int, cin: int, cout: int, device) -> tuple:
    """:func:`int8_operands` with mul and badd at a YOLO CBS's true scale
    (a 16th of the ReLU operands'), so that the epilogue's f32 values spread
    about 4 around 0 and the SiLU's negative lobe matters."""
    x, wp, mul, badd = int8_operands(seed, b, h, w, cin, cout, device)
    return x, wp, mul / 16, badd / 16


def int8_check(x, wp, mul, badd, out_dtype, x2=None, act="relu", inv_s=None) -> float:
    """The int8 kernel against its plain version run on the card, on one
    input: equal outputs (raises otherwise); -> the max abs difference (0)."""
    got = conv3x3_int8(x, wp, mul, badd, out_dtype, x2, act=act, inv_s=inv_s)
    want = conv3x3_int8_reference(x, wp, mul, badd, out_dtype, x2, act=act, inv_s=inv_s)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        n_diff = int((got != want).sum())
        raise RuntimeError(f"conv3x3_int8 ({act}) differs from its plain version at "
                           f"{(*x.shape, 0 if x2 is None else x2.shape[3], mul.shape[0])} -> "
                           f"{out_dtype}: {n_diff} of {got.numel()} elements, max abs err {err}")
    return err


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


# run by a copy of the package laid out as installed (outside any checkout)
INSTALLED_PROBE = """
import ctypes
import unet_medical_image_contour_segmentation_torch as port
from unet_medical_image_contour_segmentation_torch.kernels import _build
lib = _build.build(["conv3x3"])["conv3x3"].library
ctypes.CDLL(str(lib))
print(port.__file__)
print(lib)
"""


def start_installed_build(tmp: Path) -> subprocess.Popen:
    """Copy the package into ``tmp``/site-packages, as a wheel installs it,
    and build its 3x3 kernel there in a process of its own, with HOME in
    ``tmp`` and no UMICS_COMPILE_CACHE_DIR."""
    site = tmp / "site-packages"
    shutil.copytree(REPO / PORT_NAME, site / PORT_NAME,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "work").mkdir()
    env = dict(os.environ, HOME=str(tmp / "home"), PYTHONPATH=str(site))
    env.pop(compile_cache.CACHE_DIR_ENV, None)
    return subprocess.Popen([sys.executable, "-c", INSTALLED_PROBE], cwd=tmp / "work", env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def check_build_dirs(results: dict, probe: subprocess.Popen, tmp: Path) -> dict:
    """The checkout's libraries lie under its build/torch_kernels/ (under
    $UMICS_COMPILE_CACHE_DIR/torch_kernels when that is set); the installed
    copy's under its HOME's ~/.cache/umics/torch_kernels, outside the tree
    it was installed into."""
    override = os.environ.get(compile_cache.CACHE_DIR_ENV)
    want = (Path(override) / "torch_kernels" if override
            else REPO / "build" / "torch_kernels")
    misplaced = {n: str(r.library) for n, r in results.items() if r.library.parent != want}
    out, err = probe.communicate(timeout=_build.NVCC_TIMEOUT_S + 120)
    lines = out.split()
    home_dir = tmp / "home" / ".cache" / "umics" / "torch_kernels"
    if (misplaced or probe.returncode != 0 or len(lines) != 2
            or Path(lines[0]).parent != tmp / "site-packages" / PORT_NAME
            or Path(lines[1]).parent != home_dir):
        raise RuntimeError(f"[build] libraries outside {want}: {misplaced}; the installed "
                           f"copy (exit {probe.returncode}) built {lines[1:]} from {lines[:1]}, "
                           f"want {home_dir}:\n{err[-3000:]}")
    log(f"[build] the checkout's libraries lie in {want}; a copy installed as into "
        f"site-packages built {Path(lines[1]).name} into $HOME/.cache/umics/torch_kernels "
        f"and loaded it")
    return {"checkout": str(want), "installed": str(lines[1])}


def phase_build() -> tuple:
    """Build every source; -> (ptxas's {kernel: "R registers, S/L bytes
    spill stores/loads"} for the 3x3 kernels ("f32", "mma<NT>", and the int8
    kernels "int8_tma<N,OUT>" / "int8_im2col<N,OUT>" with ReLU,
    "int8_tma<N,OUT,silu>" with SiLU), the build directories).  An int8
    kernel that spills fails the run (its wgmma accumulators must stay in
    registers), as does a library outside the build directory that
    check_build_dirs wants.  An installed copy of the package builds the
    3x3 kernel beside the checkout's build, in a process of its own."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        probe = start_installed_build(Path(tmp))
        try:
            results = _build.build(["conv3x3", "conv3x3_int8", "bias_relu"])
            dirs = check_build_dirs(results, probe, Path(tmp))
        finally:
            if probe.poll() is None:
                probe.kill()
                probe.communicate()
    log(f"[build] {len(results)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    usage, name, spills = {}, None, ""
    for r in results.values():
        log(f"[build] {r.name}: nvcc {r.seconds:.2f} s -> {r.library.name}")
        for line in r.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling", "arning")):
                log(f"[build]   {line.strip()}")
            m = re.search(r"conv3x3_int8_(tma|im2col)_kernelILi(\d+)ELi(\d+)E(?:Li(\d+)E)?"
                          r"|conv3x3_mma_kernelILi(\d+)E|conv3x3_kernelIfE", line)
            if m and "Compiling" in line:
                silu = ",silu" if m.group(4) == "1" else ""
                name = (f"int8_{m.group(1)}<{m.group(2)},{m.group(3)}{silu}>" if m.group(1)
                        else f"mma<{m.group(5)}>" if m.group(5) else "f32")
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
            elif (m := re.search(r"Used (\d+) registers", line)) and name:
                usage[name] = f"{m.group(1)} registers, {spills}"
                name = None
    spilled = {k: v for k, v in usage.items() if k.startswith("int8") and not v.endswith(
        "0/0 bytes spill stores/loads")}
    if spilled or not any(k.startswith("int8_tma") for k in usage):
        raise RuntimeError(f"int8 kernels spill, or ptxas printed none of them: {spilled}")
    return usage, dirs


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


def folded_outputs(model, hw: int = 64) -> list:
    """(C, downsampling) of each output of the one-pass bias + ReLU in a
    served forward of ``model``, in the order the forward makes them: one
    f32 forward of its serving copy on the CPU at (1, hw, hw), each folded
    block's two conv widths read at its output's width."""
    import copy

    net = serving_copy(copy.deepcopy(model).float().cpu())
    net.compute_dtype = None
    rows = []

    def record(block, args, out):
        rows.extend((w.shape[3], hw // out.shape[2]) for w in (block.w1, block.w2))

    hooks = [m.register_forward_hook(record) for m in net.modules()
             if isinstance(m, FoldedDoubleConv)]
    try:
        with torch.no_grad():
            net(torch.zeros(1, hw, hw, net.n_channels))
    finally:
        for h in hooks:
            h.remove()
    return rows


def bias_relu_key(y: torch.Tensor) -> tuple:
    return (*y.shape, str(y.dtype))


def bias_relu_check(shape: tuple, dtype, seed: int) -> None:
    """The pass at ``shape`` in ``dtype`` on seeded operands (a NaN in y and
    in the bias, -0.0 in both, a pixel that the bias cancels exactly), bit
    for bit against ``torch.relu(y + b)``, under inference mode as the
    Predictor runs it; the shape joins BR_CHECKED, or the run fails."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    y = torch.randn(shape, generator=g, device="cuda").to(dtype)
    b = torch.randn((c,), generator=g, device="cuda").to(dtype)
    y[0, 0, 0, 0] = float("nan")
    y[-1, -1, -1, -1] = -0.0
    y[0, -1, -1] = -b
    b[0] = y[0, 0, -1, 0] = -0.0  # a sum of -0.0
    b[c // 2] = float("nan")
    with torch.inference_mode():
        got, want = bias_relu_nhwc(y, b), bias_relu_nhwc_reference(y, b)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(bits), want.view(bits)):
        raise RuntimeError(f"bias_relu_nhwc at {shape} {dtype} differs from torch.relu(y + b) "
                           f"in {int((got.view(bits) != want.view(bits)).sum())} elements")
    BR_CHECKED.add(bias_relu_key(y))


def phase_bias_relu() -> list:
    """The one-pass bias + ReLU (csrc/bias_relu.cu): bit for bit the plain
    pair ``torch.relu(y + b)`` at every shape unet_s's served forward gives
    it at (BATCH, HW, HW), in bf16 and in f32 (:func:`bias_relu_check`);
    then at BIAS_RELU_SHAPES in bf16 its device ms against the byte bound
    (y read and the output written once, the bias once, at 3.35 TB/s), the
    pair's ms as ``library_ms`` (the plain version is that same pair), and
    the host's µs a call of each, there and at a shape small enough that
    the host alone sets the pace."""
    main = sorted({(BATCH, HW // d, HW // d, c) for c, d in folded_outputs(unet_s())})
    for i, shape in enumerate(main):
        for dtype in (torch.bfloat16, torch.float32):
            bias_relu_check(shape, dtype, seed=100 + i)
    log(f"[bias_relu] bit for bit torch.relu(y + b) at the {len(main)} (B, H, W, C) shapes of "
        f"unet_s's served forward, bf16 and f32 (NaN, -0.0 and cancelling sums): {main}")
    rows = []
    for name, b, h, w, c in BIAS_RELU_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(c)
        y = torch.randn((b, h, w, c), generator=g, device="cuda").to(torch.bfloat16)
        bias = torch.randn((c,), generator=g, device="cuda").to(torch.bfloat16)
        y[0, 0, 0, :2] = float("nan")
        ys = copies(y)
        with torch.inference_mode():
            got = bias_relu_nhwc(y, bias)
            want = bias_relu_nhwc_reference(y, bias)
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise RuntimeError(f"bias_relu_nhwc at {tuple(y.shape)} differs from "
                                   f"torch.relu(y + b) in {int((got != want).sum())} elements")
            ms, host_ms = time_ms(lambda i: bias_relu_nhwc(ys[i % len(ys)], bias), reps=40)
            pair_ms, pair_host_ms = time_ms(
                lambda i: bias_relu_nhwc_reference(ys[i % len(ys)], bias), reps=40)
        bound_ms = (2 * y.numel() + c) * y.element_size() / HBM_BYTES_PER_S * 1e3
        share = roofline(bound_ms, kernel=ms, library=pair_ms)
        rows.append(dict(name=name, path="dense", shape=[b, h, w, c], ms=ms, bound_ms=bound_ms,
                         library_ms=pair_ms, roofline=share, host_us=host_ms * 1e3,
                         library_host_us=pair_host_ms * 1e3))
        log(f"[bias_relu] {name} {(b, h, w, c)} bf16: equal to torch.relu(y + b); kernel "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms (bytes; roofline {share:.1%}, "
            f"{(2 * y.numel() + c) * y.element_size() / ms / 1e9:.3f} TB/s), "
            f"torch.relu(y + b) {pair_ms:.4f} ms; host {host_ms * 1e3:.2f} us a call "
            f"against the pair's {pair_host_ms * 1e3:.2f} us")
    # the host's cost alone: a (1, 8, 8, 64) tensor, which the card takes
    # faster than the host issues it; median of 5 runs of 500 calls
    y, bias = torch.randn((1, 8, 8, 64), device="cuda"), torch.randn((64,), device="cuda")
    host = {}
    with torch.inference_mode():
        for label, fn in (("op", bias_relu_nhwc), ("pair", bias_relu_nhwc_reference)) * 2:
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(500):
                    fn(y, bias)
                host.setdefault(label, []).append((time.perf_counter() - t0) / 500 * 1e6)
            torch.cuda.synchronize()
    host = {k: float(np.median(v)) for k, v in host.items()}
    log(f"[bias_relu] host us a call at (1, 8, 8, 64) f32 (median of 10 x 500 calls): op "
        f"{host['op']:.2f}, torch.relu(y + b) {host['pair']:.2f}")
    for r in rows:
        r["small_host_us"], r["small_library_host_us"] = host["op"], host["pair"]
    return rows


# (B, H, W, Cin, Cout, dtype) of every conv3x3 launch held against the plain
# version by phases 3 and 4, and of every launch inside a counted window of
# the main paths (reset_launches .. read_launches / int8_counts): the run
# fails unless the second set lies in the first (phase_launched_shapes)
CHECKED, LAUNCHED = set(), set()
# the same for the int8 kernel: (B, H, W, Cin, Cin2, Cout, out dtype, act),
# held against the plain version in phase 10, or in phase 17 where phase 10
# has no such shape
CHECKED8, LAUNCHED8 = set(), set()
# the same for the one-pass bias + ReLU: (B, H, W, C, dtype), held against
# torch.relu(y + b) in phase 3 (unet_s's served forward) or in phase 18
BR_CHECKED, BR_LAUNCHED = set(), set()
RECORDING = [False]


def int8_key(x, x2, cout, out_dtype, act) -> tuple:
    return (*x.shape, 0 if x2 is None else x2.shape[3], cout, str(out_dtype), act)


def record_launches() -> None:
    """Wrap the kernels' one launch path (``_build.launch``) so that each
    launch made while a counted window is open records its shape, from the
    operands as the op received them (the counts stay ``LAUNCHES``)."""
    launch = _build.launch
    keys = {
        "conv3x3_nhwc": (LAUNCHED, lambda x, w: (*x.shape, w.shape[3], str(x.dtype))),
        "conv3x3_int8": (LAUNCHED8, lambda x, wp, mul, badd, out_dtype, x2=None, act="relu",
                         inv_s=None: int8_key(x, x2, mul.shape[0], out_dtype, act)),
        "bias_relu_nhwc": (BR_LAUNCHED, lambda y, b: bias_relu_key(y)),
    }
    keys["conv3x3_nhwc_dx"] = keys["conv3x3_nhwc"]

    def recorded(op, *operands):
        if RECORDING[0]:
            launched, key = keys[op]
            launched.add(key(*operands))
        return launch(op, *operands)

    _build.launch = recorded


def conv_label(path: str) -> str:
    """A conv's label from its module path: a DoubleConv's ``{block}.conv{1,2}``
    (``down1.maxpool_conv.1.double_conv.0`` -> ``down1.conv1``, ``x0_1.double_conv.3``
    -> ``x0_1.conv2``), else the path without its ``.conv`` holder
    (``c2f0.m0.cv1.conv`` -> ``c2f0.m0.cv1``)."""
    if ".double_conv." in path:
        return f"{path.split('.')[0]}.conv{1 if path.endswith('.0') else 2}"
    return path.removesuffix(".conv")


def routed_convs(model, hw: int = 64) -> list:
    """(name, Cin, Cout, downsampling) of each 3x3 conv of ``model`` that the
    dispatch rule sends to the kernel (``kernels/conv3x3.py:supported``), in
    the order the forward calls them: one f32 eval forward of a copy on the
    CPU at (1, hw, hw) records each call of the kernel's wrapper, its conv
    found by the weight's storage and its downsampling read from its input's
    width.  Named as in MAIN_CONVS (:func:`conv_label`)."""
    import copy

    net = copy.deepcopy(model).float().cpu().eval()
    net.compute_dtype = None
    names = {m.weight.data_ptr(): conv_label(path) for path, m in net.named_modules()
             if isinstance(m, torch.nn.Conv2d)}
    rows, wrapper = [], conv3x3_module.conv3x3_nhwc

    def recorded(x, w):
        rows.append((names[w.data_ptr()], w.shape[2], w.shape[3], hw // x.shape[2]))
        return wrapper(x, w)

    conv3x3_module.conv3x3_nhwc = recorded
    try:
        with torch.no_grad():
            net(torch.zeros(1, hw, hw, net.n_channels))
    finally:
        conv3x3_module.conv3x3_nhwc = wrapper
    return rows


def new_shapes(rows) -> list:
    """The rows whose (Cin, Cout, downsampling) MAIN_CONVS lacks, one each."""
    seen, out = {c[1:] for c in MAIN_CONVS}, []
    for row in rows:
        if row[1:] not in seen:
            seen.add(row[1:])
            out.append(row)
    return out


def train_shapes() -> list:
    """(label, Cin, Cout, downsampling) of the routed convs of the models the
    train phases run (unet_s multiclass and binary, unet_sa, the bilinear
    unet_s, unet_pp_s, yolov8_seg_s), one per shape, MAIN_CONVS first; fails
    where unet_s's own are not MAIN_CONVS."""
    if routed_convs(unet_s()) != MAIN_CONVS:
        raise RuntimeError(f"unet_s routes {routed_convs(unet_s())}, not MAIN_CONVS")
    models = (("binary", unet_s(n_classes=1)), ("unet_sa", unet_sa()),
              ("bilinear", unet_s(bilinear=True)), ("unet_pp_s", get_model("unet_pp_s")),
              ("yolo", get_model("yolov8_seg_s")))
    rows = [(f"{label} {name}", *shape) for label, model in models
            for name, *shape in routed_convs(model)]
    return list(MAIN_CONVS) + new_shapes(rows)


def phase_kernels(usage: dict):
    """Kernel vs plain at every shape that a main path gives it, both dtypes;
    bf16 timings at the dense, ragged and tiled shapes, the plain version's
    too (no yardstick of speed: its im2col patch).  The other paths'
    shapes (the train variants' own convs, the int8 calibration forward,
    the exported program's wide image) are checked, not timed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(name, BATCH, HW // s, HW // s, cin, cout, "dense")
              for name, cin, cout, s in MAIN_CONVS]
    shapes.append((*RAGGED, "ragged"))
    shapes += [(f"{name}@{win}", b, win // s, win // s, cin, cout, f"tiled{win}")
               for b, win in TILED_WINDOWS for name, cin, cout, s in MAIN_CONVS]
    shapes += [(name, BATCH, HW // s, HW // s, cin, cout, "train")
               for name, cin, cout, s in train_shapes()[len(MAIN_CONVS):]]
    b1, win1 = TILED_ONE_IMAGE
    shapes += [(f"{name}@{b1}x{win1}", b1, win1 // s, win1 // s, cin, cout, "one-image tiled")
               for name, cin, cout, s in MAIN_CONVS]
    shapes += [(f"{name}@calib", CALIB_BATCH, HW // s, HW // s, cin, cout, "calibrate")
               for name, cin, cout, s in MAIN_CONVS]
    eh, ew = EXPORT_WIDE
    shapes += [(f"{name}@{eh}x{ew}", 1, eh // s, ew // s, cin, cout, "export")
               for name, cin, cout, s in MAIN_CONVS]
    # yolov8_seg_s (C4): the shapes unet_s lacks, timed; its exported program's
    # 1024x768 image, checked
    yolo = routed_convs(get_model("yolov8_seg_s"))
    shapes += [(f"yolo {name}", BATCH, HW // s, HW // s, cin, cout, "yolo")
               for name, cin, cout, s in new_shapes(yolo)]
    shapes += [(f"yolo {name}@{eh}x{ew}", 1, eh // s, ew // s, cin, cout, "export")
               for name, cin, cout, s in yolo]
    # its int8 calibration forward (C5): the CBS fold at (CALIB_BATCH, HW, HW)
    shapes += [(f"yolo {name}@calib", CALIB_BATCH, HW // s, HW // s, cin, cout, "calibrate")
               for name, cin, cout, s in yolo]
    # S1-S6: a rank's band of rows and its two halo rows; S1's and S5's timed
    shapes += [(name, b, h, w, cin, cout, path or "spatial variant")
               for name, b, h, w, cin, cout, path in s_shapes()]
    rows, max_err = [], 0.0
    for name, b, h, w, cin, cout, path in shapes:
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
            CHECKED.add((b, h, w, cin, cout, str(dtype)))
            timed = (path in ("dense", "ragged", "yolo", "spatial", "spatial_yolo")
                     or path.startswith("tiled"))
            if dtype != torch.bfloat16 or not timed:
                log(f"[kernels] {name:16s} {str((b, h, w, cin, cout)):26s} "
                    f"{'f32 ' if dtype == torch.float32 else 'bf16'} max_abs_err {err:.3g} ok"
                    f"{'' if timed else f' ({path} path)'}")
                continue
            xs = copies(x)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ms, host_ms = time_ms(lambda i: conv3x3_nhwc(xs[i % len(xs)], wt), reps=20)
            # the plain version's f32 im2col patch of a tiled group is ~9 GB:
            # its calls are timed as issued, not queued behind a sleep
            plain_ms, _ = time_ms(lambda i: conv3x3_nhwc_reference(xs[i % len(xs)], wt),
                                  reps=2 if path.startswith("tiled") else 3, warmup=1,
                                  queued=not path.startswith("tiled"))
            library_ms, library_host_ms = time_ms(
                lambda i: F.conv2d(xs[i % len(xs)].permute(0, 3, 1, 2), w_oihw, padding=1),
                reps=20)
            del xs
            bound_ms, bound_by = conv_bound_ms(b, h, w, cin, cout, dtype)
            share = roofline(bound_ms, kernel=ms, library=library_ms)
            use = kernel_usage(usage, cin, cout, dtype)
            rows.append(dict(name=name, path=path, shape=[b, h, w, cin, cout], ms=ms,
                             plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             roofline=share, max_abs_err=err, host_ms=host_ms,
                             library_host_ms=library_host_ms, **use))
            log(f"[kernels] {name:16s} {str((b, h, w, cin, cout)):26s} bf16 "
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
    a sum does not shrink with the element it lands in).

    The train variants' own shapes (train_shapes beyond MAIN_CONVS) are
    checked, not timed."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, max_err = [], 0.0
    rows_in = [(name, BATCH, HW // s, HW // s, cin, cout, i < len(MAIN_CONVS), "train")
               for i, (name, cin, cout, s) in enumerate(train_shapes())]
    # D2: each rank's RANK_BATCH rows of unet_s's step
    rows_in += [(f"{name}@rank", RANK_BATCH, HW // s, HW // s, cin, cout, False, "train")
                for name, cin, cout, s in MAIN_CONVS]
    # S1-S3, S5: a rank's band of rows and its two halo rows (S4 and S6 run no
    # backward); S1's and S5's timed
    rows_in += [(name, b, h, w, cin, cout, path is not None, path or "spatial variant")
                for name, b, h, w, cin, cout, path in s_shapes() if name[:2] not in ("S4", "S6")]
    for name, b, h, w, cin, cout, timed, path in rows_in:
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
            CHECKED.add((b, h, w, cout, cin, str(dtype)))  # dx launches Cout -> Cin
            if dtype != torch.bfloat16 or not timed:
                log(f"[backward] {name:12s} {str((b, h, w, cin, cout)):26s} "
                    f"{'f32 ' if dtype == torch.float32 else 'bf16'} dx max_abs_err "
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
            rows.append(dict(name=name, path=path, shape=[b, h, w, cout, cin], ms=ms,
                             plain_ms=plain_ms,
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


def int8_bound_ms(b, h, w, cin, cout, out_dtype):
    """(ms, "bytes" | "operations") of one int8 conv: x, the packed weight,
    mul and badd read once, y written once (int8, or 2-byte bf16 when it
    dequantises), against 2*9*Cin*Cout operations per pixel at the int8
    tensor-core peak."""
    out_bytes = torch.empty((), dtype=out_dtype).element_size()
    nbytes = b * h * w * (cin + cout * out_bytes) + 9 * cin * cout + 8 * cout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * h * w * 9 * cin * cout / PEAK_FLOPS[torch.int8] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_mm_ms(x: torch.Tensor, wp: torch.Tensor, cout: int):
    """``torch._int_mm`` of the im2col patch matrix (B*H*W, 9*Cin_p) by the
    packed weight's (9*Cin_p, Cout) -> int32, the patch built beforehand
    (not timed), inputs rotated past the L2: a yardstick for the int8
    kernel's main loop, not the same function (no halo, no epilogue).  None
    where its shape rules refuse the shape."""
    wm = int8_weight_matrix(wp, cout).t()
    cin_p = wm.shape[0] // 9
    patch = _patches(F.pad(x, (0, cin_p - x.shape[3]))).reshape(-1, 9 * cin_p)
    try:
        torch._int_mm(patch[:64], wm)
        ps = copies(patch)
        return time_ms(lambda i: torch._int_mm(ps[i % len(ps)], wm), reps=20)[0]
    except RuntimeError as exc:
        log(f"[int8-kernels]   torch._int_mm refuses {tuple(patch.shape)} x "
            f"{tuple(wp.t().shape)}: {str(exc).splitlines()[0]}")
        return None


def phase_int8_kernels(usage: dict):
    """The int8 kernel against its plain version, exactly, at the 18 unet_s
    convs at (BATCH, HW, HW) and at the tiled path's 16 windows of 704²,
    each with its main-path epilogue (int8, or bf16 dequant), and at the
    four Up conv1s as the int8 forward runs them, split (skip, upsample)
    inputs, at both sizes; at the dense shapes its time, the plain
    version's, the bf16 path's conv at the same shape (``ops.nn.conv2d``:
    the bf16 kernel where 8 <= Cin <= 32, cuDNN otherwise) and
    ``torch._int_mm`` on the im2col patch (:func:`int_mm_ms`), inputs
    rotated past the L2, calls queued.  The kernel label, grid, tile and
    stages of a row are the built kernel's own (:func:`kernel_geometry`),
    and the run fails where ``launch_geometry``, its Python mirror, differs."""
    b704, w704 = TILED_WINDOWS[0]
    shapes = [(name, BATCH, HW // s, HW // s, cin, cout, out, "dense", 0)
              for name, cin, cout, s, out in INT8_CONVS]
    shapes += [(f"{name}@{w704}", b704, w704 // s, w704 // s, cin, cout, out, f"tiled{w704}", 0)
               for name, cin, cout, s, out in INT8_CONVS]
    shapes += [(f"{name} split", BATCH, HW // s, HW // s, cin // 2, cout, out, "split", cin // 2)
               for name, cin, cout, s, out in INT8_CONVS if name in SPLIT_CONVS]
    shapes += [(f"{name} split@{w704}", b704, w704 // s, w704 // s, cin // 2, cout, out,
                f"tiled{w704}", cin // 2)
               for name, cin, cout, s, out in INT8_CONVS if name in SPLIT_CONVS]
    # unet_pp_s's nested conv1s (C2): the j skips and the upsample, checked
    shapes += [(f"pp {name} split", BATCH, HW // s, HW // s, cin, cout, "int8", "pp", cin2)
               for name, cin, cin2, cout, s in PP_SPLIT_CONVS]
    # yolov8_seg_s's SiLU convs (C5), timed
    shapes += [(f"yolo {name}", BATCH, HW // s, HW // s, cin, cout, out, "yolo", 0)
               for name, cin, cout, s, out, _ in YOLO_SILU_CONVS]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, max_err = [], 0.0
    for i, (name, b, h, w, cin, cout, out, path, cin2) in enumerate(shapes):
        out_dtype = torch.int8 if out == "int8" else torch.bfloat16
        act = "silu" if path == "yolo" else "relu"
        operands = silu_operands if act == "silu" else int8_operands
        x, wp, mul, badd = operands(70 + i, b, h, w, cin + cin2, cout, "cuda")
        x, x2 = (x[..., :cin].contiguous(), x[..., cin:].contiguous()) if cin2 else (x, None)
        inv_s = (torch.tensor(SILU_INV_S, device="cuda")
                 if act == "silu" and out == "int8" else None)
        err = int8_check(x, wp, mul, badd, out_dtype, x2, act, inv_s)
        CHECKED8.add(int8_key(x, x2, cout, out_dtype, act))
        max_err = max(max_err, err)
        # the channels the kernel gets: Cin >= 16 padded to a multiple of 16
        cin_k = cin + -cin % 16 if cin >= 16 else cin
        geo = kernel_geometry(b, h, w, cin_k, cout, cin2)
        if geo != launch_int8_geometry(b, h, w, cin_k, cout, cin2):
            raise RuntimeError(f"launch_geometry differs from the built kernel's at {name}: "
                               f"{launch_int8_geometry(b, h, w, cin_k, cout, cin2)} against {geo}")
        if path.startswith("tiled") or path == "pp":
            log(f"[int8-kernels] {name:20s} {str((b, h, w, cin, cin2, cout)):30s} -> {out:5s} "
                f"equal; grid {geo.grid}, tile {geo.tile}")
            continue
        xs, x2s = copies(x), copies(x2) if cin2 else None
        ms, host_ms = time_ms(lambda i: conv3x3_int8(xs[i % len(xs)], wp, mul, badd, out_dtype,
                                                     x2s[i % len(x2s)] if cin2 else None,
                                                     act=act, inv_s=inv_s),
                              reps=20)
        plain_ms, _ = time_ms(lambda i: conv3x3_int8_reference(
            xs[i % len(xs)], wp, mul, badd, out_dtype, x2s[i % len(x2s)] if cin2 else None,
            act=act, inv_s=inv_s), reps=2, warmup=1)
        del xs, x2s
        cin_all = cin + cin2
        mm_ms = int_mm_ms(x if x2 is None else torch.cat([x, x2], dim=-1), wp, cout)
        xb = torch.randn(b, h, w, cin_all, device="cuda", generator=gen).to(torch.bfloat16)
        wb = (torch.randn(3, 3, cin_all, cout, device="cuda", generator=gen)
              / (3 * cin_all ** 0.5)).to(torch.bfloat16)
        xbs = copies(xb)
        with torch.inference_mode():
            bf16_ms, _ = time_ms(lambda i: conv2d(xbs[i % len(xbs)], wb, padding=1), reps=20)
        del xbs, xb
        bound_ms, bound_by = int8_bound_ms(b, h, w, cin_all, cout, out_dtype)
        share = roofline(bound_ms, kernel=ms)
        key = (f"int8_{geo.route}<{geo.n},{0 if out == 'int8' else 2}"
               f"{',silu' if act == 'silu' else ''}>")
        rows.append(dict(name=name, path=path, shape=[b, h, w, cin_all, cout], cin2=cin2,
                         out=out, act=act, ms=ms, plain_ms=plain_ms, library_ms=None,
                         int_mm_ms=mm_ms, bf16_path_ms=bf16_ms, bound_ms=bound_ms,
                         bound_by=bound_by, roofline=share, max_abs_err=err, host_ms=host_ms,
                         kernel=key, ptxas=usage.get(key, "not printed"), grid=geo.grid,
                         tile=list(geo.tile), stages=geo.stages, smem_bytes=geo.smem_bytes))
        mm = "refused" if mm_ms is None else f"{mm_ms:.4f} ms"
        log(f"[int8-kernels] {name:16s} {str((b, h, w, cin_all, cout)):26s} -> {out:5s} "
            f"{act} equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 path {bf16_ms:.4f} ms, "
            f"_int_mm {mm}, bound {bound_ms:.4f} ms ({bound_by}), roofline {share:.1%}, "
            f"host issue {host_ms * 1e3:.1f} us; {key}: {usage.get(key, 'not printed')}, "
            f"grid {geo.grid}, tile {geo.tile}, {geo.stages} stages, {geo.smem_bytes} B")
    return rows, max_err


def random_unet_params(seed: int, widths=(16, 32, 64, 128, 256), n_channels=1, n_classes=3,
                       bilinear=False, attention=False):
    """UNet weights in the JAX package's layout (numpy pytrees), from a seed:
    He-normal convs and BN affines / running stats near identity; unet_s by
    default, bilinear ups and unet_sa's attention convs when asked."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout, fan_in):
        return rng.normal(0, np.sqrt(2.0 / fan_in), (k, k, cin, cout)).astype(np.float32)

    def bn(c):
        return ({"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                 "bias": rng.normal(0, 0.1, c).astype(np.float32)},
                {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                 "var": rng.uniform(0.8, 1.2, c).astype(np.float32)})

    def double_conv(cin, cout, cmid=None):
        cmid = cmid or cout
        (p1, s1), (p2, s2) = bn(cmid), bn(cout)
        params = {"conv1": {"w": conv(3, cin, cmid, 9 * cin)}, "bn1": p1,
                  "conv2": {"w": conv(3, cmid, cout, 9 * cmid)}, "bn2": p2}
        return params, {"bn1": s1, "bn2": s2}

    w, f = widths, 2 if bilinear else 1
    params, state = {}, {}
    params["inc"], state["inc"] = double_conv(n_channels, w[0])
    for i, (cin, cout) in enumerate([(w[0], w[1]), (w[1], w[2]), (w[2], w[3]),
                                     (w[3], w[4] // f)], 1):
        params[f"down{i}"], state[f"down{i}"] = double_conv(cin, cout)
    for i, (cin, cout) in enumerate([(w[4], w[3] // f), (w[3], w[2] // f), (w[2], w[1] // f),
                                     (w[1], w[0])], 1):
        conv_p, conv_s = double_conv(cin, cout, cin // 2 if bilinear else None)
        params[f"up{i}"] = {"conv": conv_p}
        if not bilinear:
            params[f"up{i}"]["upconv"] = {"w": conv(2, cin, cin // 2, cin),
                                          "b": np.zeros(cin // 2, np.float32)}
        if attention:
            params[f"up{i}"]["att"] = {"conv": {"w": conv(7, 2, 1, 2 * 49)}}
        state[f"up{i}"] = {"conv": conv_s}
    params["outc"] = {"w": conv(1, w[0], n_classes, w[0]), "b": np.zeros(n_classes, np.float32)}
    return params, state


def random_params_like(model, seed: int):
    """Seeded weights in the JAX package's layout (numpy pytrees) for any
    port model, with the tree of its own state_dict: He-normal convs (fan
    in = kh * kw * Cin), N(0, 0.1) conv and ConvTranspose biases, and BN
    affines / running stats near identity, each leaf drawn in sorted path
    order.  UNet++ and YOLOv8-seg take their weights from here."""
    params, state, _ = params_from_state_dict(model.state_dict())
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "w":
                fan_in = v.shape[0] * v.shape[1] * v.shape[2]
                out[k] = rng.normal(0, np.sqrt(2.0 / fan_in), v.shape).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            else:  # b, BN bias, mean
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        return out

    return fill(params), fill(state)


def seeded_model(name: str, seed: int, centre: bool = True, **kw):
    """``get_model(name, **kw)`` (UNet++, YOLOv8-seg, any of the zoo) with
    :func:`random_params_like` weights, in eval mode; with ``centre`` the
    head biases (``outc``, ``out{j}``, ``head``) are then shifted so that
    the classes split a noise image's pixels: each class's mean logit to 0,
    or for one class the median logit to 0 (sigmoid > 0.5 on half)."""
    model = get_model(name, **kw)
    params, state = random_params_like(model, seed)
    model.load_state_dict(state_dict_from_jax(params, state))
    if not centre:
        return model.eval()
    probe = np.random.default_rng(seed + 1).random((1, 128, 128), dtype=np.float32)
    with torch.inference_mode():
        logits = model.eval()(torch.from_numpy(probe))
    shift = (logits.median() if model.n_classes == 1 else logits.mean(dim=(0, 1, 2))).numpy()
    for head in [k for k in params if k in ("outc", "head") or re.fullmatch(r"out\d+", k)]:
        params[head]["b"] = (params[head]["b"] - shift).astype(np.float32)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def build_model(seed: int, factory=unet_s, class2_share=None):
    """A UNet (unet_s by default) from seeded weights; the head bias is then
    centred so that the three classes split the pixels of a noise image,
    which keeps the mask comparisons from passing on a constant map.  With
    ``class2_share``, class 2 is then raised until it wins on that share of
    the noise image's pixels (the pipeline needs class-2 regions to trace)."""
    model = factory()
    params, state = random_unet_params(seed, model.widths, bilinear=model.bilinear,
                                       attention=model.use_attention)
    model.load_state_dict(state_dict_from_jax(params, state))
    probe = np.random.default_rng(seed + 1).random((1, 128, 128), dtype=np.float32)
    with torch.inference_mode():
        logits = model.eval()(torch.from_numpy(probe))
    bias = -logits.mean(dim=(0, 1, 2))
    if class2_share is not None:
        centred = logits + bias
        lead = centred[..., :2].amax(dim=-1) - centred[..., 2]
        bias[2] += torch.quantile(lead.ravel(), class2_share)
    params["outc"]["b"] = bias.numpy()
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


def write_raw_scans(directory, seed: int, n: int, width: int, height: int) -> None:
    """``n`` little-endian uint16 RAW frames ``scan{i:02d}.raw`` in ``directory``:
    a smooth background in [15000, 45000] and one bright ellipse (60000)."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((n, 1, 8, 12), dtype=np.float32))
    background = F.interpolate(coarse, size=(height, width), mode="bicubic").clamp(0, 1)
    yy, xx = np.mgrid[:height, :width]
    for i in range(n):
        frame = 15000 + background[i, 0].numpy() * 30000
        (cy, ry), (cx, rx) = [(rng.uniform(0.3, 0.7) * d, rng.uniform(0.15, 0.3) * d)
                              for d in (height, width)]
        frame[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 60000
        frame.astype("<u2").tofile(os.path.join(directory, f"scan{i:02d}.raw"))


# the counts read_launches() returns: the 3x3 kernel's forward and dx
# launches, those on the tensor cores, and the one-pass bias + ReLU's
LAUNCH_KEYS = ("conv3x3_nhwc", "conv3x3_nhwc.tensor_core", "conv3x3_nhwc_dx",
               "conv3x3_nhwc_dx.tensor_core", "bias_relu_nhwc")


def reset_launches() -> None:
    """Set every count to 0 and open a counted window (its launches' shapes
    are recorded until the counts are read)."""
    LAUNCHES.clear()
    RECORDING[0] = True


def int8_counts() -> dict:
    """The int8 kernel's launches beside the bf16 kernel's, since the last reset."""
    RECORDING[0] = False
    return {key: LAUNCHES[key] for key in ("conv3x3_int8", "conv3x3_nhwc")}


def read_launches() -> dict:
    """The counts of LAUNCH_KEYS since the last reset."""
    RECORDING[0] = False
    return {key: LAUNCHES[key] for key in LAUNCH_KEYS}


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
    if launches != fwd_launches(2 * per_forward, 2 * UNET_PASSES):
        raise RuntimeError(f"two predict forwards launched {launches}, want "
                           f"{2 * per_forward} forward launches, all on the tensor cores, "
                           f"no dx launches, and {2 * UNET_PASSES} bias + ReLU passes")
    check_masks(masks, (BATCH, HW, HW))
    check_masks(masks_u8, (BATCH, HW, HW))
    log(f"[main] unet_s bf16 predict_array (8, 512, 512) float + uint8: "
        f"conv3x3_nhwc launches {launches['conv3x3_nhwc']} ({per_forward} per forward, all on "
        f"the tensor-core kernel), bias_relu_nhwc {launches['bias_relu_nhwc']}; "
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
        profile_forward(lambda: pred.model(x).argmax(-1), Path(profile_dir))
    return launches, dict(slices_per_s=BATCH * reps / dt, batch_ms=dt / reps * 1e3,
                          latency_p50_ms=lat_p50, latency_p80_ms=lat_p80,
                          forward_ms=fwd_ms, peak_mib=peak / 2**20,
                          agreement=min(agree, agree_u8))


def profile_forward(forward, out_dir: Path, name: str = "predict") -> None:
    """torch.profiler table of 5 calls of ``forward()`` (after 3 warm-ups)."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with torch.inference_mode():
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                forward()
            torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / f"{name}_profile.txt").write_text(table)
    log(f"[profile] 5 {name} forwards at (8, 512, 512); table in {out_dir}/{name}_profile.txt")
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


def seeded_unet_s(compute_dtype=None, n_classes=3, factory=unet_s, **kw):
    """unet_s (or ``factory``'s UNet) with the seeded JAX-layout weights,
    unfolded, for training; ``kw`` goes to the factory (bilinear, remat)."""
    model = factory(n_classes=n_classes, compute_dtype=compute_dtype, **kw)
    params, state = random_unet_params(MODEL_SEED, model.widths, n_classes=n_classes,
                                       bilinear=model.bilinear, attention=model.use_attention)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def one_train_step(device: str, data: dict, n_classes: int = 3, build=None):
    """One f32 step of the seeded unet_s (or of ``build()``'s model) on
    ``device`` -> host (metrics, clipped grads, new params, buffers);
    ``n_classes=1`` takes the binary criterion."""
    model = (build() if build else seeded_unet_s(n_classes=n_classes)).to(device)
    step = make_train_step(model, LossConfig(n_classes=n_classes),
                           RMSpropConfig(learning_rate=TRAIN_LR))
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    with exact_f32():
        metrics = step(batch, TRAIN_LR)
    return host_step(model, metrics)


def phase_train_reference(n_classes: int = 3, build=None, label=None) -> None:
    """One f32 train step (TF32 off) on the card against the CPU's, with the
    multiclass criterion, or the binary one for ``n_classes=1``; of the
    seeded unet_s, or of a fresh ``build()`` on each side (logged as
    ``label``).

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
        one_train_step("cuda", data, n_classes, build),
        one_train_step("cpu", data, n_classes, build))
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
    label = label or ("train-reference" if n_classes == 3 else "A1 binary train-reference")
    log(f"[{label}] (2, 64, 96) f32 step, card vs CPU: loss {m_card['loss']:.6f} "
        f"(rel {loss_err:.3g}), grad norm {m_card['grad_norm']:.6f} (rel {norm_err:.3g}), "
        f"grads max abs diff {grad_err:.3g} of the largest gradient {g_max:.3g} (relative "
        f"to its own max, worst {worst}: {grad_diff[worst]:.3g} of "
        f"{g_cpu[worst].abs().max().item():.3g}), params max abs diff "
        f"{param_diff.max().item():.3g} ({(param_diff > 1e-6).float().mean().item():.4%} "
        f"of elements over 1e-6), BN buffers within 1e-4")


def train_steps(model, loss_cfg, batch, label: str, per_step: int,
                per_step_fwd: int = None):
    """TRAIN_WARMUP + TRAIN_STEPS steps of ``model`` on one resident batch:
    gates ``per_step_fwd`` (default ``per_step``) forward and ``per_step``
    dx launches a step, all on the tensor cores, and a finite falling loss;
    -> (launches, numbers, the step)."""
    per_step_fwd = per_step if per_step_fwd is None else per_step_fwd
    step = make_train_step(model, loss_cfg, RMSpropConfig(learning_rate=TRAIN_LR))
    want = {"conv3x3_nhwc": per_step_fwd, "conv3x3_nhwc.tensor_core": per_step_fwd,
            "conv3x3_nhwc_dx": per_step, "conv3x3_nhwc_dx.tensor_core": per_step,
            "bias_relu_nhwc": 0}

    reset_launches()
    losses = [step(batch, TRAIN_LR)["loss"]]
    if read_launches() != want:
        raise RuntimeError(f"[{label}] one train step launched {read_launches()}, want {want}")
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
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise RuntimeError(f"[{label}] {n_steps} train steps launched {launches}, want "
                           f"{want} a step")
    curve = torch.stack(losses).tolist()
    if not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise RuntimeError(f"[{label}] the train loss is not finite and falling: {curve}")
    log(f"[{label}] {model.name} bf16 make_train_step ({BATCH}, {HW}, {HW}): "
        f"{per_step_fwd + per_step} kernel launches per step ({per_step_fwd} forward + "
        f"{per_step} dx, all on the tensor-core kernel), {launches} in {n_steps} steps; "
        f"loss {' '.join(f'{v:.4f}' for v in curve)}")
    log(f"[{label}] step {step_ms:.3f} ms (CUDA events, {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-ups, batch resident), {BATCH * 1e3 / step_ms:.1f} slices/s, "
        f"peak memory {peak / 2**20:.1f} MiB")
    return launches, dict(step_ms=step_ms, slices_per_s=BATCH * 1e3 / step_ms,
                          peak_mib=peak / 2**20, loss_first=curve[0],
                          loss_last=curve[-1]), step


def device_batch(seed: int) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in rect_batch(seed, BATCH, HW, HW).items()}


def phase_train(profile_dir=None):
    """make_train_step on the seeded unet_s at (BATCH, HW, HW), bf16 compute,
    one resident batch: launches per step, the loss curve, step time.
    -> (launches, numbers, the trained model)."""
    model = seeded_unet_s(torch.bfloat16).cuda()
    batch = device_batch(6)
    launches, numbers, step = train_steps(model, LossConfig(), batch, "train", len(MAIN_CONVS))
    if profile_dir:
        profile_train(step, batch, Path(profile_dir))
    return launches, numbers, model


def phase_train_binary(multiclass: dict):
    """A1: the binary criterion (BCE + Dice + 0.25 * boundary, edge 51 and
    15) on the seeded unet_s with one output channel, as phase 7 trains the
    multiclass one; then the boundary term's own device time at those
    logits and its share of the step."""
    model = seeded_unet_s(torch.bfloat16, n_classes=1).cuda()
    batch = device_batch(6)
    cfg = LossConfig(n_classes=1)
    launches, numbers, _ = train_steps(model, cfg, batch, "A1 binary train",
                                       len(MAIN_CONVS))
    with torch.no_grad():
        logits = model(batch["image"])
    t = torch.div(batch["mask"], 2, rounding_mode="floor").float()
    bl_ms, _ = time_ms(lambda i: boundary_loss(logits, t, edge_width=cfg.boundary_edge_width,
                                               edge_weight=cfg.boundary_edge_weight),
                       reps=20, queued=False)
    numbers.update(boundary_ms=bl_ms, boundary_share=bl_ms / numbers["step_ms"])
    log(f"[A1 binary train] step {numbers['step_ms']:.3f} ms, {numbers['slices_per_s']:.1f} "
        f"slices/s, peak {numbers['peak_mib']:.1f} MiB, beside the multiclass step's "
        f"{multiclass['step_ms']:.3f} ms, {multiclass['slices_per_s']:.1f} slices/s, "
        f"{multiclass['peak_mib']:.1f} MiB (binary / multiclass step "
        f"{numbers['step_ms'] / multiclass['step_ms']:.3f}); the boundary term "
        f"{bl_ms:.3f} ms a call (CUDA events, issued as the step issues it), "
        f"{numbers['boundary_share']:.1%} of the step")
    return launches, numbers


def phase_train_variants() -> dict:
    """A2: unet_sa and the bilinear unet_s train as phase 7 does; each must
    launch the kernel once a step (forward and dx) for every conv the
    dispatch rule routes."""
    out, launches = {}, {}
    for name, kw in (("unet_sa", dict(factory=unet_sa)), ("unet_s_bilinear",
                                                          dict(bilinear=True))):
        model = seeded_unet_s(torch.bfloat16, **kw).cuda()
        per_step = len(routed_convs(model))
        launches[name], out[name], _ = train_steps(model, LossConfig(), device_batch(6),
                                                   f"A2 {name} train", per_step)
        out[name]["routed_convs"] = per_step
    return launches, out


# the step of a fresh model is timed after 2 more warm-ups, over 10 steps
# (5 steps straight after the first one timed unet_s's plain step at 30.3
# and 46.4 ms in two runs on the same card)
REMAT_WARMUP, REMAT_TIMED_STEPS = 2, 10


def remat_step(model, batch, profile_dir=None):
    """One bf16 step -> (loss, grads, BN buffers, peak memory in MiB, launches),
    then REMAT_WARMUP + REMAT_TIMED_STEPS more -> the mean ms of the last
    REMAT_TIMED_STEPS (CUDA events); with
    ``profile_dir``, then a profile of 3 steps (:func:`profile_train`)."""
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=TRAIN_LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss = step(batch, TRAIN_LR)["loss"].item()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    buffers = {n: b.detach().clone() for n, b in model.named_buffers()}
    for _ in range(REMAT_WARMUP):
        step(batch, TRAIN_LR)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REMAT_TIMED_STEPS):
        step(batch, TRAIN_LR)
    end.record()
    torch.cuda.synchronize()
    if profile_dir:
        profile_train(step, batch, Path(profile_dir),
                      f"{model.name}_{'remat' if model.remat else 'plain'}")
    return loss, grads, buffers, peak, launches, start.elapsed_time(end) / REMAT_TIMED_STEPS


def remat_equals_plain(runs: dict, per_step: int, label: str) -> tuple:
    """``runs`` {remat: remat_step(...)} of one model's plain and remat step
    from the same weights and batch: the same loss (1e-6 relative),
    gradients within phase 6's bound (1e-3 of the largest), bit-equal BN
    running statistics and num_batches_tracked, and the remat step's
    launches 2 * per_step forward (the recompute) + per_step dx; -> (loss
    relative difference, gradient difference of the largest)."""
    (loss, grads, bufs, _, _, _), (r_loss, r_grads, r_bufs, _, r_launch, _) = (
        runs[False], runs[True])
    want = {"conv3x3_nhwc": 2 * per_step, "conv3x3_nhwc.tensor_core": 2 * per_step,
            "conv3x3_nhwc_dx": per_step, "conv3x3_nhwc_dx.tensor_core": per_step,
            "bias_relu_nhwc": 0}
    g_max = max(g.abs().max().item() for g in grads.values())
    grad_err = max((r_grads[k] - grads[k]).abs().max().item() for k in grads) / g_max
    loss_err = abs(r_loss - loss) / abs(loss)
    stats_equal = all(torch.equal(r_bufs[k], bufs[k]) for k in bufs)
    if (r_launch != want or loss_err > 1e-6 or grad_err > 1e-3 or not stats_equal
            or not np.isfinite(r_loss)):
        raise RuntimeError(f"[{label}] launches {r_launch} (want {want}), loss {r_loss} vs "
                           f"{loss}, grads {grad_err:.3g} of the max, BN buffers equal "
                           f"{stats_equal}")
    return loss_err, grad_err


def phase_remat(profile_dir=None) -> dict:
    """A3: one remat step of unet_s and one plain step from the same weights
    and batch: the same loss, gradients within phase 6's bounds, equal BN
    running statistics and num_batches_tracked, 14 forward + 7 dx launches
    (the recompute runs each routed forward again); peak memory of both,
    and of the default full unet (64..1024, no kernel launch) beside it.
    With ``profile_dir``, a profile of each unet_s step."""
    batch = device_batch(9)
    runs = {remat: remat_step(seeded_unet_s(torch.bfloat16, remat=remat).cuda(), batch,
                              profile_dir)
            for remat in (False, True)}
    (loss, _, _, peak, _, ms), (r_loss, _, _, r_peak, r_launch, r_ms) = runs[False], runs[True]
    loss_err, grad_err = remat_equals_plain(runs, len(MAIN_CONVS), "A3 remat")
    full = {}
    for remat in (False, True):
        model = seeded_unet_s(torch.bfloat16, factory=unet, remat=remat).cuda()
        full[remat] = remat_step(model, batch)
        del model
        torch.cuda.empty_cache()
    log(f"[A3 remat] unet_s bf16 ({BATCH}, {HW}, {HW}): remat step loss {r_loss:.6f}, plain "
        f"{loss:.6f} (rel {loss_err:.3g}); gradients {grad_err:.3g} of the largest; BN "
        f"running stats and num_batches_tracked bit-equal; launches {r_launch}; peak memory "
        f"remat {r_peak:.1f} MiB, plain {peak:.1f} MiB ({r_peak / peak:.3f}x); step "
        f"{r_ms:.3f} ms remat, {ms:.3f} ms plain (CUDA events, {REMAT_TIMED_STEPS} steps); "
        f"full unet (64..1024) peak remat {full[True][3]:.1f} MiB, plain "
        f"{full[False][3]:.1f} MiB ({full[True][3] / full[False][3]:.3f}x), step "
        f"{full[True][5]:.3f} ms remat, {full[False][5]:.3f} ms plain")
    return r_launch, dict(loss_rel=loss_err, grad_err=grad_err, peak_mib=peak, step_ms=ms,
                          remat_step_ms=r_ms,
                          remat_peak_mib=r_peak, unet_peak_mib=full[False][3],
                          unet_remat_peak_mib=full[True][3], unet_step_ms=full[False][5],
                          unet_remat_step_ms=full[True][5])


def phase_train_model_cc(n_train: int = 32) -> dict:
    """A4: one epoch of train_model with the binary criterion and the
    connected-component penalty on in-memory 512x512 slices: every logged
    loss is the device loss plus the host penalty of its step, and some
    penalty is not 0; the penalty's host ms per fetched step."""
    from unet_medical_image_contour_segmentation_torch.losses import connected_component

    # time each call of the penalty as the loop's fetch makes it
    penalty, cc_ms = connected_component.connected_component_loss, []

    def timed_penalty(*args, **kw):
        t0 = time.perf_counter()
        try:
            return penalty(*args, **kw)
        finally:
            cc_ms.append((time.perf_counter() - t0) * 1e3)

    import cv2  # noqa: F401  (imported before the timed calls)

    model = seeded_unet_s(torch.bfloat16, n_classes=1)
    records = []
    cwd = os.getcwd()
    connected_component.connected_component_loss = timed_penalty
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(model="unet_s", classes=1, cc_loss=True, epochs=1, batch_size=BATCH,
                          learning_rate=TRAIN_LR, amp=True, num_workers=4,
                          save_checkpoint=False, save_val_predictions=False,
                          val_postprocess=False, progress=False, log_every=0)
        os.chdir(tmp)
        try:
            result = train_model(cfg, model=model, train_set=ArrayDataset(rect_batch(
                10, n_train, HW, HW)), val_set=ArrayDataset(rect_batch(11, BATCH, HW, HW)),
                device="cuda", metric_backends=[lambda kind, rec: records.append((kind, rec))])
        finally:
            os.chdir(cwd)
            connected_component.connected_component_loss = penalty
    steps = [rec for kind, rec in records if kind == "train_step"]
    worst = max(abs(r["loss"] - (r["ce"] + r["dice"] + cfg.boundary_weight * r["boundary"]
                                 + r["cc"])) / abs(r["loss"]) for r in steps)
    if (len(steps) != n_train // BATCH or result.step != len(steps) or worst > 1e-6
            or len(cc_ms) != len(steps)
            or not all(np.isfinite(r["loss"]) and r["cc"] >= 0 for r in steps)
            or not any(r["cc"] > 0 for r in steps)):
        raise RuntimeError(f"[A4 train_model cc] the logged losses are not the device loss "
                           f"plus the host penalty (worst rel {worst:.3g}): {steps}")
    penalties = " ".join(f"{r['cc']:.4f}" for r in steps)
    times = " ".join(f"{t:.1f}" for t in cc_ms)
    log(f"[A4 train_model cc] 1 epoch, {len(steps)} binary steps with --cc-loss: logged loss = "
        f"device loss + host penalty (worst rel {worst:.3g}); penalties {penalties}; the "
        f"penalty took {times} ms on the host per fetched step of ({BATCH}, {HW}, {HW})")
    return dict(cc_host_ms=cc_ms, worst_rel=worst, cc=[r["cc"] for r in steps])


def profile_train(step, batch, out_dir: Path, name: str = "train", by_cpu: bool = False) -> None:
    """torch.profiler table of 3 steps; logs the table's head and its host
    and device totals (the profiler's "Self CPU/CUDA time total"); with
    ``by_cpu``, also the table by self CPU time (where a host-bound step's
    time goes)."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch, TRAIN_LR)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    (out_dir / f"{name}_profile.txt").write_text(table)
    totals = [line for line in table.splitlines() if line.startswith("Self ")]
    log(f"[profile] 3 bf16 {name} steps at ({BATCH}, {HW}, {HW}); table in "
        f"{out_dir}/{name}_profile.txt; {'; '.join(totals)}")
    log("\n".join(table.splitlines()[:30]))
    if by_cpu:
        cpu = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25)
        (out_dir / f"{name}_profile_cpu.txt").write_text(cpu)
        log("\n".join(cpu.splitlines()[:25]))


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


TRAIN_MODEL_EPOCHS = 2


def phase_train_model(n_train: int = 32):
    """The slice's main path: train_model on in-memory 512x512 slices for
    TRAIN_MODEL_EPOCHS epochs, a checkpoint saved after each (asynchronously,
    on the loop's writer thread), progress, post-processing and prediction
    dumps off; it must not import tqdm, PIL or cv2, it must launch the
    kernel 7 + 7 times a step and 7 times a validation forward, and the
    last periodic checkpoint must equal the final model_epoch{N}.npz array
    for array (both hold the final state).  -> (launches, numbers)."""
    train_set = ArrayDataset(rect_batch(7, n_train, HW, HW))
    val_set = ArrayDataset(rect_batch(8, 2 * BATCH, HW, HW))
    epochs = TRAIN_MODEL_EPOCHS
    records = []
    before = {m for m in HOST_ONLY_MODULES if m in sys.modules}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(model="unet_s", epochs=epochs, batch_size=BATCH,
                          learning_rate=TRAIN_LR, amp=True, num_workers=4, checkpoint_every=1,
                          checkpoint_after_frac=0.0,
                          dir_checkpoint=os.path.join(tmp, "checkpoints"),
                          predictions_dir=os.path.join(tmp, "predictions"),
                          save_val_predictions=False, val_postprocess=False, progress=False,
                          log_every=0)
        os.chdir(tmp)
        model = seeded_unet_s(torch.bfloat16)
        try:
            reset_launches()
            t0 = time.perf_counter()
            result = train_model(cfg, model=model, train_set=train_set, val_set=val_set,
                                 device="cuda",
                                 metric_backends=[lambda kind, rec: records.append((kind, rec))])
            seconds = time.perf_counter() - t0
            launches = read_launches()
        finally:
            os.chdir(cwd)
        final_path = os.path.join(tmp, f"model_epoch{epochs}.npz")
        final = load_checkpoint(final_path)
        periodic = [os.path.join(tmp, "checkpoints", f"checkpoint_epoch{e}.npz")
                    for e in range(1, epochs + 1)]
        written = [os.path.exists(f) for f in periodic]
        differing = npz_differences(periodic[-1], final_path) if all(written) else None
    loaded = sorted({m for m in HOST_ONLY_MODULES if m in sys.modules} - before)
    val = [rec for kind, rec in records if kind == "validation"]
    steps = epochs * (n_train // BATCH)
    fwd = steps * len(MAIN_CONVS) + epochs * (len(val_set) // BATCH) * len(MAIN_CONVS)
    want = {"conv3x3_nhwc": fwd, "conv3x3_nhwc.tensor_core": fwd,
            "conv3x3_nhwc_dx": steps * len(MAIN_CONVS),
            "conv3x3_nhwc_dx.tensor_core": steps * len(MAIN_CONVS), "bias_relu_nhwc": 0}
    train_losses = [rec["loss"] for kind, rec in records if kind == "train_step"]
    if (result.step != steps or final["step"] != steps or final["opt_state"] is None
            or not all(written) or differing or loaded or len(val) != epochs
            or len(train_losses) != steps or launches != want
            or not np.all(np.isfinite(train_losses))
            or not np.all(np.isfinite([v[k] for v in val for k in ("dice", "dice_postprocessed",
                                                                    "min_dice")]))):
        raise RuntimeError(f"train_model: steps {result.step} (want {steps}), checkpoint "
                           f"step {final['step']}, opt_state {final['opt_state'] is not None}, "
                           f"periodic checkpoints {written}, arrays of the last one that "
                           f"differ from the final one {differing}, imported {loaded}, "
                           f"launches {launches} (want {want}), records {records}")
    v = val[-1]
    rates = [r["slices_per_sec"] for r in val]
    log(f"[train_model] {epochs} epochs, {n_train} slices {HW}x{HW} in batches of {BATCH}: "
        f"{' '.join(f'{x:.1f}' for x in rates)} slices/s by epoch (host clock, the epoch's "
        f"train loop), {seconds:.2f} s end to end with validation and {epochs} asynchronous "
        f"checkpoints; launches {launches}; checkpoint_epoch{epochs}.npz equals "
        f"model_epoch{epochs}.npz array for array; validation (dice, dice_postprocessed, "
        f"min_dice) = ({v['dice']:.4f}, {v['dice_postprocessed']:.4f}, {v['min_dice']:.4f}); "
        f"train losses {' '.join(f'{x:.4f}' for x in train_losses)}; no import of "
        f"{HOST_ONLY_MODULES}")
    return launches, dict(slices_per_s=rates, seconds=seconds, dice=v["dice"],
                          dice_postprocessed=v["dice_postprocessed"], min_dice=v["min_dice"])


def npz_differences(a: str, b: str) -> list:
    """The keys of two .npz files whose arrays differ, or that one lacks."""
    with np.load(a) as za, np.load(b) as zb:
        keys = set(za.files) | set(zb.files)
        return sorted(k for k in keys if k not in za.files or k not in zb.files
                      or not np.array_equal(za[k], zb[k]))


SAVE_REPS = 3


def phase_checkpoint_save() -> dict:
    """The seconds the training thread spends in a checkpoint save of the
    full unet (widths 64..1024) with its RMSprop state, bf16 compute and f32
    master weights on the card: save_checkpoint against
    save_checkpoint_async (the call, then the worker's write), SAVE_REPS
    times in turns; each asynchronous file must equal the synchronous one
    written from the same state."""
    model = seeded_unet_s(torch.bfloat16, factory=unet).cuda()
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=TRAIN_LR))
    step({k: torch.from_numpy(v).cuda() for k, v in rect_batch(9, 2, 64, 64).items()},
         TRAIN_LR)  # RMSprop's state exists from the first step
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    times = {"sync_s": [], "async_call_s": [], "async_write_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(SAVE_REPS):
            sync_path = os.path.join(tmp, f"sync{rep}.npz")
            async_path = os.path.join(tmp, f"async{rep}.npz")
            t0 = time.perf_counter()
            save_checkpoint(sync_path, model, step=step.step, optimizer=step.optimizer)
            times["sync_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fut = save_checkpoint_async(async_path, model, step=step.step,
                                        optimizer=step.optimizer)
            times["async_call_s"].append(time.perf_counter() - t0)
            fut.result()
            times["async_write_s"].append(time.perf_counter() - t0)
            differing = npz_differences(sync_path, async_path)
            if differing:
                raise RuntimeError(f"[save] the asynchronous checkpoint differs from the "
                                   f"synchronous one at {differing}")
            nbytes = os.path.getsize(sync_path)
            os.remove(sync_path)
            os.remove(async_path)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[save] full unet ({n_params} parameters, {nbytes / 2**20:.1f} MiB .npz with the "
        f"RMSprop state), seconds on the training thread, {SAVE_REPS} saves each in turns: "
        f"save_checkpoint {' '.join(f'{x:.4f}' for x in times['sync_s'])}; "
        f"save_checkpoint_async {' '.join(f'{x:.4f}' for x in times['async_call_s'])} "
        f"(its write done after {' '.join(f'{x:.4f}' for x in times['async_write_s'])}); "
        f"median {med['sync_s']:.4f} against {med['async_call_s']:.4f} "
        f"({med['sync_s'] / med['async_call_s']:.1f}x); asynchronous files equal the "
        f"synchronous ones")
    return dict(params=n_params, npz_mib=nbytes / 2**20, **times,
                **{f"median_{k}": v for k, v in med.items()})


@contextlib.contextmanager
def synchronous_saves():
    """train_model's periodic saves made on the loop's thread, as before
    save_checkpoint_async (a comparison for the timing only)."""
    from concurrent.futures import Future

    from unet_medical_image_contour_segmentation_torch.engine import train as train_module

    def save_now(path, model, step=0, mask_values=None, extra=None, optimizer=None, *,
                 executor=None):
        save_checkpoint(path, model, step, mask_values, extra, optimizer)
        done = Future()
        done.set_result(None)
        return done

    train_module.save_checkpoint_async = save_now
    try:
        yield
    finally:
        train_module.save_checkpoint_async = save_checkpoint_async


def phase_train_model_saves(n_train: int = 32) -> dict:
    """train_model of the full unet (bf16, 2 epochs of 4 steps at (8, 512,
    512), a checkpoint of ~355 MiB after each) with its periodic saves
    asynchronous, as the loop makes them, against the same saves made on
    the loop's thread, in turns (async, sync, sync, async): seconds end to
    end and each epoch's slices/s (the writer thread shares the host, and
    its GIL, with a host-bound loop)."""
    import copy

    base = seeded_unet_s(torch.bfloat16, factory=unet)
    train_set = ArrayDataset(rect_batch(13, n_train, HW, HW))
    val_set = ArrayDataset(rect_batch(14, BATCH, HW, HW))
    runs = {"async": [], "sync": []}
    cwd = os.getcwd()
    for mode in ("async", "sync", "sync", "async"):
        records = []
        with tempfile.TemporaryDirectory() as tmp, (
                synchronous_saves() if mode == "sync" else contextlib.nullcontext()):
            cfg = TrainConfig(model="unet", epochs=2, batch_size=BATCH, learning_rate=TRAIN_LR,
                              amp=True, num_workers=4, checkpoint_every=1,
                              checkpoint_after_frac=0.0,
                              dir_checkpoint=os.path.join(tmp, "checkpoints"),
                              save_val_predictions=False, val_postprocess=False,
                              progress=False, log_every=0)
            os.chdir(tmp)
            try:
                t0 = time.perf_counter()
                train_model(cfg, model=copy.deepcopy(base), train_set=train_set,
                            val_set=val_set, device="cuda",
                            metric_backends=[lambda kind, rec: records.append((kind, rec))])
                seconds = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
        runs[mode].append(dict(seconds=seconds, slices_per_s=[
            rec["slices_per_sec"] for kind, rec in records if kind == "validation"]))
    text = "; ".join(f"{mode} " + ", ".join(
        f"{r['seconds']:.3f} s ({' '.join(f'{x:.1f}' for x in r['slices_per_s'])} slices/s)"
        for r in rs) for mode, rs in runs.items())
    log(f"[train_model saves] full unet, 2 epochs with a checkpoint after each, in turns "
        f"(async, sync, sync, async): {text}")
    return runs


PREFETCH_BATCHES = 24
PREFETCH_REPS = 5
# the consumer's fixed device work a batch: long enough that the thread's
# pinning of each 16 MiB batch keeps ahead of it, so that the card sets the
# pace
PREFETCH_BUSY_S = 6e-3


def prefetch_host_batches(seed: int, n: int, b: int = BATCH, hw: int = HW) -> list:
    """n seeded batches: (b, hw, hw, 1) f32 images and (b, hw, hw) int32 masks."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.random((b, hw, hw, 1), dtype=np.float32),
             "mask": rng.integers(0, 3, (b, hw, hw), dtype=np.int32)} for _ in range(n)]


def prefetch_gate(host: list, device="cuda", busy_cycles: int = 0, zero: bool = True) -> tuple:
    """``host`` through prefetch_to_device into a consumer that queues a
    busy-wait of ``busy_cycles``, counts on the card the elements of each
    batch that differ from its host batch (uploaded beforehand), and, with
    ``zero``, zeroes the batch and drops it (the allocator-reuse hazard: a
    later copy into that memory would race the queued work).  -> (differing
    elements, batches seen, device ms a batch from the first batch's arrival
    on the card to the last one's end (CUDA events))."""
    ref = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in host]
    bad = torch.zeros((), dtype=torch.int64, device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    seen = 0
    for i, batch in enumerate(prefetch_to_device(iter(host), device)):
        if i == 0:
            start.record()
        if busy_cycles:
            torch.cuda._sleep(busy_cycles)
        for k, t in batch.items():
            bad += (t != ref[i][k]).sum()
            if zero:
                t.zero_()
        seen += 1
        del batch, t
    end.record()
    torch.cuda.synchronize()
    return int(bad), seen, start.elapsed_time(end) / max(seen, 1)


def phase_prefetch() -> dict:
    """prefetch_to_device on the card: PREFETCH_BATCHES seeded batches of
    (BATCH, HW, HW, 1) f32 images and int32 masks into a consumer with a
    fixed device busy-wait a batch.  Gates: every yielded batch equals its
    host batch, with the consumer zeroing and dropping each one after use,
    and without.  Reports the time per batch against the consumer's work
    alone, the copy alone and both in line on one stream (the copy on the
    compute stream, as before the side stream), and, as a control, the
    differing elements when record_stream is skipped (the hazard the gate
    is for)."""
    host = prefetch_host_batches(12, PREFETCH_BATCHES)
    busy = int(PREFETCH_BUSY_S * SLEEP_HZ)
    n = len(host)
    for zero in (True, False):
        bad, seen, _ = prefetch_gate(host, busy_cycles=busy, zero=zero)
        if bad or seen != n:
            raise RuntimeError(f"[prefetch] {bad} elements differ from the host batches "
                               f"({seen} of {n} batches seen, zero after use {zero})")
    # timing, each in turns PREFETCH_REPS times (a stall of the shared host
    # shows in one run, not in the median): the prefetch, the consumer alone,
    # the copy alone on a side stream, and copy + consumer in line on the
    # compute stream
    for _ in range(2):  # the second pass reuses the first's freed pinned blocks
        pinned = None
        t0 = time.perf_counter()
        pinned = [{k: torch.from_numpy(v).pin_memory() for k, v in b.items()} for b in host]
        pin_ms = (time.perf_counter() - t0) / n * 1e3
    resident = [{k: v.cuda() for k, v in b.items()} for b in pinned]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def consumer(batch):
        torch.cuda._sleep(busy)
        for t in batch.values():
            (t != t).sum()
            t.zero_()

    def device_ms(body):
        torch.cuda.synchronize()
        start.record()
        body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def copies_alone():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for b in pinned:
                for v in b.values():
                    v.to("cuda", non_blocking=True)
        torch.cuda.current_stream().wait_stream(side)

    def in_line():
        for b in pinned:
            consumer({k: v.to("cuda", non_blocking=True) for k, v in b.items()})

    times = {"prefetch": [], "consumer": [], "copy": [], "in_line": []}
    for _ in range(PREFETCH_REPS):
        times["prefetch"].append(prefetch_gate(host, busy_cycles=busy)[2])
        times["consumer"].append(device_ms(lambda: [consumer(b) for b in resident]))
        times["copy"].append(device_ms(copies_alone))
        times["in_line"].append(device_ms(in_line))
    med = {k: float(np.median(v)) for k, v in times.items()}
    hidden = (med["consumer"] + med["copy"] - med["prefetch"]) / med["copy"]
    # the control: without record_stream the allocator may hand a dropped
    # batch's memory to a later copy while the zeroing is still queued
    record_stream = torch.Tensor.record_stream
    torch.Tensor.record_stream = lambda self, stream: None
    try:
        unsafe_bad = prefetch_gate(host, busy_cycles=busy)[0]
    finally:
        torch.Tensor.record_stream = record_stream
    mib = sum(v.nbytes for v in host[0].values()) / 2**20
    log(f"[prefetch] {n} batches of {mib:.0f} MiB ({BATCH}, {HW}, {HW}, 1) f32 images + int32 "
        f"masks: every yielded batch equals its host batch, zeroed and dropped after use or "
        f"not; ms a batch on the card (medians of {PREFETCH_REPS}, in turns): prefetch "
        f"{med['prefetch']:.4f} ({' '.join(f'{x:.4f}' for x in times['prefetch'])}), "
        f"consumer alone {med['consumer']:.4f}, copy alone "
        f"{med['copy']:.4f}, copy and consumer in line on one stream {med['in_line']:.4f}; "
        f"{hidden:.1%} of the copy hidden behind the consumer; pinning {pin_ms:.4f} ms a "
        f"batch on the host (the thread's pace); without record_stream "
        f"{unsafe_bad} elements differed (the hazard the gate catches)")
    return dict(batches=n, batch_mib=mib, busy_s=PREFETCH_BUSY_S, ms=times, pin_ms=pin_ms,
                **{f"median_{k}_ms": v for k, v in med.items()}, copy_hidden=hidden,
                unsafe_differing=unsafe_bad)


def tiled_logits(model, x: torch.Tensor, tile: int, halo: int) -> torch.Tensor:
    """The tiled forward as a plain loop, for margins: (n, H, W[, C]) float
    images on the model's device -> (n, H, W, classes) logits, each tile's
    from the core of its window of the zero-padded image."""
    x = x if x.dim() == 4 else x.unsqueeze(-1)
    n, h, w, _ = x.shape
    ph, pw, win = -h % tile, -w % tile, tile + 2 * halo
    padded = F.pad(x, (0, 0, halo, halo + pw, halo, halo + ph))
    out = None
    with torch.inference_mode():
        for i in range(0, h + ph, tile):
            for j in range(0, w + pw, tile):
                logits = model(padded[:, i:i + win, j:j + win].contiguous())
                if out is None:
                    out = logits.new_empty((n, h + ph, w + pw, logits.shape[-1]))
                out[:, i:i + tile, j:j + tile] = logits[:, halo:halo + tile, halo:halo + tile]
    return out[:, :h, :w]


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def group_forwards(pred, n: int, h: int, w: int) -> int:
    """Forwards of one tiled predict_array call: groups of tpb tiles."""
    tile = pred.tile or pred._auto_tile(h, w)
    tiles = -(-h // tile) * -(-w // tile)
    per_chunk = -(-tiles // min(pred.tile_batch, tiles))
    return per_chunk * -(-n // pred.batch_size)


def interior(masks: np.ndarray) -> np.ndarray:
    return masks[:, HALO:-HALO, HALO:-HALO]


TILED_REPS = 5
# (n, hw) of the tiled runs: the auto tile is 512 at 2048² (4 tiles of 1024
# are too few) and 1024 at 4096²
TILED_SIZES = ((2, 2048), (1, 4096))


def phase_tiled(model):
    """Tiled predict_array, unet_s bf16 with the MODEL_SEED weights: (2, 2048,
    2048) float and uint8 at the auto tile (512), (1, 4096, 4096) at the auto
    tile (1024) and at tile 512.  7 kernel launches per window-group forward,
    all on the tensor cores; masks agree with f32 tiled masks (TF32 off) on
    >= 99% of pixels; tiled agrees with dense on >= 99.9% of the interior in
    f32 and >= 99% in bf16 (>= HALO from the border; near it the two are
    different functions, see engine/predict.py); on a small image the card's
    f32 tiled masks equal the CPU's on decided pixels.  Host-clock slices/s and megapixels/s,
    device ms per image (CUDA events, image resident), peak memory; dense at
    2048² beside it."""
    (n2, s2), (n4, s4) = TILED_SIZES
    small, big = sorted(Predictor.AUTO_TILES)
    img2 = smooth_images(21, n2, s2, cells=s2 // 32)
    img2_u8 = np.round(img2 * 255).astype(np.uint8)
    img4 = smooth_images(22, n4, s4, cells=s4 // 32)
    bf16 = dict(device="cuda", compute_dtype=torch.bfloat16, tile_halo=HALO)
    auto, t_small = Predictor(model, **bf16), Predictor(model, tile=small, **bf16)
    dense = Predictor(model, tile_threshold=0, **bf16)
    if (auto._auto_tile(s2, s2), auto._auto_tile(s4, s4)) != (small, big):
        raise RuntimeError("the auto tile rule changed")
    runs = [(f"{s2} float", auto, img2), (f"{s2} uint8", auto, img2_u8),
            (f"{s4} tile{big}", auto, img4), (f"{s4} tile{small}", t_small, img4)]
    for _, pred, images in runs:  # warm-up: cuDNN picks its algorithms per shape
        pred.predict_array(images)
    torch.cuda.synchronize()

    reset_launches()
    masks = [pred.predict_array(images) for _, pred, images in runs]
    launches = read_launches()
    forwards = sum(group_forwards(pred, *images.shape[:3]) for _, pred, images in runs)
    per_forward = len(MAIN_CONVS)
    if launches != fwd_launches(per_forward * forwards, UNET_PASSES * forwards):
        raise RuntimeError(f"{forwards} tiled group forwards launched {launches}, want "
                           f"{per_forward} each, all on the tensor cores, and "
                           f"{UNET_PASSES} bias + ReLU passes each")
    for (name, _, images), m in zip(runs, masks):
        check_masks(m, images.shape[:3])
    log(f"[tiled] unet_s bf16 predict_array, halo {HALO}, {', '.join(n for n, _, _ in runs)}: "
        f"{forwards} window-group forwards, conv3x3_nhwc launches "
        f"{launches['conv3x3_nhwc']} ({per_forward} per forward, all on the tensor-core kernel)")

    with exact_f32():
        f32_auto = Predictor(model, device="cuda", tile_halo=HALO)
        f32_small = Predictor(model, device="cuda", tile=small, tile_halo=HALO)
        ref = [f32_auto.predict_array(img2), f32_auto.predict_array(img2_u8),
               f32_auto.predict_array(img4), f32_small.predict_array(img4)]
        f32_dense = Predictor(model, device="cuda", tile_threshold=0)
        ref_dense = [f32_dense.predict_array(img2), f32_dense.predict_array(img2_u8)]
        ref_dense += [f32_dense.predict_array(img4)] * 2
    dense_masks = [dense.predict_array(img2), dense.predict_array(img2_u8)]
    dense_masks += [dense.predict_array(img4)] * 2
    result = {}
    for (name, _, _), m, r, d, rd in zip(runs, masks, ref, dense_masks, ref_dense):
        agree = float((m == r).mean())
        inner = float((interior(m) == interior(d)).mean())
        inner_f32 = float((interior(r) == interior(rd)).mean())
        diff = int((interior(m) != interior(d)).sum())
        diff_f32 = int((interior(r) != interior(rd)).sum())
        border = float((m != d).mean())
        log(f"[tiled] {name}: bf16 vs f32 tiled masks agree on {agree:.4%}; tiled vs dense "
            f"agree on {inner_f32:.4%} of the interior in f32 ({diff_f32} pixels differ) and "
            f"{inner:.4%} in bf16 ({diff} pixels differ); bf16 tiled and dense differ on "
            f"{border:.4%} of the whole image")
        if min(agree, inner) < MIN_AGREEMENT or inner_f32 < MIN_INTERIOR_AGREEMENT:
            raise RuntimeError(f"{name}: bf16 vs f32 agreement {agree:.4%} or bf16 interior "
                               f"tiled vs dense {inner:.4%} (< {MIN_AGREEMENT:.0%}), or f32 "
                               f"interior tiled vs dense {inner_f32:.4%} "
                               f"(< {MIN_INTERIOR_AGREEMENT:.1%})")
        result[name] = dict(agreement_f32=agree, interior_agreement_dense_f32=inner_f32,
                            interior_pixels_differ_f32=diff_f32, interior_agreement_dense=inner,
                            interior_pixels_differ=diff, whole_image_differ_dense=border)
    phase_tiled_reference(model)

    for name, pred, images in runs + [(f"{s2} dense", dense, img2)]:
        n, h, w = images.shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TILED_REPS):
            pred.predict_array(images)
        dt = (time.perf_counter() - t0) / TILED_REPS
        peak = torch.cuda.max_memory_allocated()
        x = torch.from_numpy(images[..., None]).cuda()
        if pred is dense:
            with torch.inference_mode():
                dev_ms, _ = time_ms(lambda i: dense._classes(dense.model(x)), reps=TILED_REPS,
                                    warmup=2, queued=False)
        else:
            tile = pred.tile or pred._auto_tile(h, w)
            dev_ms, _ = time_ms(lambda i: pred._tile_grid(x, tile, HALO), reps=TILED_REPS,
                                warmup=2, queued=False)
        del x
        row = result.setdefault(name, {})
        row.update(slices_per_s=n / dt, megapixels_per_s=n * h * w / dt / 1e6,
                   call_ms=dt * 1e3, device_ms_per_image=dev_ms / n, peak_mib=peak / 2**20)
        log(f"[tiled] {name} ({n}, {h}, {w}): {n / dt:.3f} slices/s, "
            f"{n * h * w / dt / 1e6:.1f} megapixels/s (host clock, {TILED_REPS} calls of "
            f"{dt * 1e3:.2f} ms, host array in, host masks out); device {dev_ms / n:.3f} ms "
            f"per image (CUDA events, image resident); peak memory {peak / 2**20:.1f} MiB")
    r_big, r_small = result[f"{s4} tile{big}"], result[f"{s4} tile{small}"]
    r_tiled, r_dense = result[f"{s2} float"], result[f"{s2} dense"]
    log(f"[tiled] {s4}²: tile {big} / tile {small} device time "
        f"{r_big['device_ms_per_image'] / r_small['device_ms_per_image']:.3f}, slices/s "
        f"{r_big['slices_per_s'] / r_small['slices_per_s']:.3f}; {s2}²: tiled / dense device "
        f"time {r_tiled['device_ms_per_image'] / r_dense['device_ms_per_image']:.3f}")
    return launches, result


def phase_tiled_reference(model) -> None:
    """(1, 320, 448), tile 128: the card's f32 tiled masks (kernel + cuDNN, TF32
    off) against the CPU's, on pixels whose top-two margin exceeds 1e-3."""
    small = smooth_images(23, 1, 448)[:, :320]
    with exact_f32():
        card = Predictor(model, device="cuda", tile=128, tile_halo=HALO, tile_threshold=1)
        got = card.predict_array(small)
        margin = top2_margin(tiled_logits(card.model, torch.from_numpy(small).cuda(), 128,
                                          HALO)).cpu().numpy()
    want = Predictor(model, device="cpu", tile=128, tile_halo=HALO,
                     tile_threshold=1).predict_array(small)
    decided = margin > 1e-3
    if not np.array_equal(got[decided], want[decided]):
        raise RuntimeError("card f32 tiled masks differ from the CPU's on decided pixels")
    log(f"[tiled-reference] (1, 320, 448) tile 128 f32: card masks equal the CPU's on "
        f"{decided.mean():.2%} decided pixels ({int((got != want).sum())} pixels differ in all)")


PIPE_SCANS, PIPE_W, PIPE_H, PIPE_TARGET = 16, 1536, 1024, 512
PIPE_WINDOW = dict(window_width=30000, window_length=35000)
LABELME_KEYS = {"version", "imagePath", "imageData", "flags", "shapes", "imageWidth",
                "imageHeight"}


class StageSeconds(logging.Handler):
    """Collects run_pipeline's per-stage seconds from its log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = {}

    def emit(self, record):
        m = re.match(r"stage (\d): .*?([\d.]+) s$", record.getMessage())
        if m:
            self.seconds[int(m.group(1))] = float(m.group(2))


def host_libraries() -> dict:
    found = {}
    for name in ("PIL", "cv2"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = None
    return found


def check_results(root: Path) -> tuple:
    """Every stage directory is filled; every labelme JSON is well formed.
    -> (JSON files, polygons)."""
    counts = {stage: len(os.listdir(root / stage)) for stage in STAGES.values()}
    if min(counts.values()) == 0 or counts["1_raw_png"] != PIPE_SCANS:
        raise RuntimeError(f"pipeline stage directories under {root}: {counts}")
    jsons = sorted((root / "5_json_results").glob("*.json"))
    polygons = 0
    for path in jsons:
        data = json.loads(path.read_text())
        pts = [np.asarray(s["points"]) for s in data["shapes"]]
        if (set(data) != LABELME_KEYS or data["version"] != "1.0.2.799"
                or (data["imageWidth"], data["imageHeight"]) != (PIPE_W, PIPE_H)
                or not pts or any(p.ndim != 2 or p.shape[1] != 2 or p.min() < 0
                                  or p[:, 0].max() >= PIPE_W or p[:, 1].max() >= PIPE_H
                                  for p in pts)):
            raise RuntimeError(f"malformed labelme JSON {path.name}")
        polygons += len(pts)
    if not jsons:
        raise RuntimeError(f"no contour JSON under {root}")
    return len(jsons), polygons


def run_timed(cfg, predictor=None):
    """run_pipeline with its stage seconds and launch counts."""
    logger = logging.getLogger(run_pipeline.__module__)
    handler, level = StageSeconds(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    reset_launches()
    try:
        t0 = time.perf_counter()
        run_pipeline(cfg, predictor=predictor)
        seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return read_launches(), handler.seconds, seconds


def phase_pipeline():
    """The 5-stage pipeline on 16 seeded synthetic 1536x1024 uint16 RAW scans:
    once with an injected unet_s Predictor (bf16, 7 kernel launches per batch
    of 8), once with the default predictor built from a saved .npz of the
    full unet (widths 64..1024: no conv with 8 <= Cin <= 32, so no kernel
    launch).  The weights' class 2 is raised so the masks have regions to
    trace.  Where PIL or cv2 does not import, says so and runs only stage
    3's device work, a letterboxed (16, 512, 512) uint8 batch through the
    full unet."""
    libs = host_libraries()
    log(f"[pipeline] host libraries: PIL {libs['PIL'] or 'does not import'}, "
        f"cv2 {libs['cv2'] or 'does not import'}")
    full = build_model(MODEL_SEED, unet, class2_share=0.6)
    if None in libs.values():
        log("[pipeline] PIL or cv2 is missing on this machine: stages 1, 2, 4 and 5 and "
            "stage 3's PNG reading, post-processing and writing cannot run; running only "
            "stage 3's device work on arrays")
        batch = np.round(smooth_images(31, PIPE_SCANS, PIPE_TARGET) * 255).astype(np.uint8)
        bar = (PIPE_TARGET - PIPE_TARGET * PIPE_H // PIPE_W) // 2  # the letterbox bars
        batch[:, :bar], batch[:, PIPE_TARGET - bar:] = 0, 0
        pred = Predictor(full, device="cuda", compute_dtype=torch.bfloat16)
        pred.predict_array(batch[:8])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        masks = pred.predict_array(batch)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        check_masks(masks, batch.shape)
        passes = -(-len(batch) // pred.batch_size) * UNET_PASSES
        if launches["conv3x3_nhwc"] or launches["bias_relu_nhwc"] != passes:
            raise RuntimeError(f"the full unet launched {launches}: want no 3x3 kernel launch "
                               f"and {passes} bias + ReLU passes")
        log(f"[pipeline] stage 3 device work only: full unet bf16 predict_array "
            f"{batch.shape} uint8 in {seconds:.3f} s, kernel launches {launches}")
        return launches, dict(host_libraries=libs, stage3_only_seconds=seconds)

    injected = Predictor(build_model(MODEL_SEED, unet_s, class2_share=0.6), device="cuda",
                         compute_dtype=torch.bfloat16)
    result = dict(host_libraries=libs)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "raws").mkdir()
        write_raw_scans(tmp / "raws", 31, PIPE_SCANS, PIPE_W, PIPE_H)
        save_checkpoint(str(tmp / "unet.npz"), full)
        injected.predict_array(np.zeros((8, PIPE_TARGET, PIPE_TARGET), np.uint8))  # warm-up
        for name, predictor, model_path in (("injected unet_s", injected, ""),
                                            ("default unet from .npz", None,
                                             str(tmp / "unet.npz"))):
            root = tmp / name.split()[0]
            stage3 = None
            if predictor is None:  # before the run: the full unet's first calls are cold
                stage3 = stage3_breakdown(model_path, tmp / "injected")
            cfg = PipelineConfig(input_raw=str(tmp / "raws"), output_root=str(root),
                                 width=PIPE_W, height=PIPE_H, model=model_path,
                                 target_size=PIPE_TARGET, **PIPE_WINDOW)
            launches, stages, seconds = run_timed(cfg, predictor)
            n_json, n_poly = check_results(root)
            batches = -(-PIPE_SCANS // injected.batch_size)
            want = batches * len(MAIN_CONVS) if predictor is injected else 0
            passes = batches * UNET_PASSES  # unet_s and the full unet both fold 9 blocks
            if ((launches["conv3x3_nhwc"], launches["conv3x3_nhwc.tensor_core"]) != (want, want)
                    or launches["bias_relu_nhwc"] != passes):
                raise RuntimeError(f"pipeline with the {name} predictor launched {launches}, "
                                   f"want {want} forward launches, all on the tensor cores, "
                                   f"and {passes} bias + ReLU passes")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            result[name] = dict(seconds=seconds, stage_seconds=stages, json_files=n_json,
                                polygons=n_poly, launches=launches["conv3x3_nhwc"])
            log(f"[pipeline] {name}: {PIPE_SCANS} RAW scans {PIPE_W}x{PIPE_H} -> "
                f"{n_json} labelme JSON files, {n_poly} polygons, in {seconds:.3f} s "
                f"({PIPE_SCANS / seconds:.2f} scans/s, host clock); stage seconds "
                f"{' '.join(f'{k}: {v:.3f}' for k, v in sorted(stages.items()))}; "
                f"conv3x3_nhwc launches {launches['conv3x3_nhwc']} (want {want})")
            if stage3 is not None:
                result[name]["stage3"] = stage3
    return total, result


BREAKDOWN_MASKS = 2


def stage3_breakdown(model_path: str, root: Path) -> dict:
    """Stage 3 of the default model in parts, on the letterboxed slices of
    the pipeline run under ``root`` (host clock): building the predictor, the
    first (cold) and a second predict_array of them (uint8), and the host
    post-processing per mask, over
    the first BREAKDOWN_MASKS masks, with their external class-2 contours
    (remove_internal_regions makes one whole-mask pass per contour)."""
    import cv2
    from PIL import Image

    t0 = time.perf_counter()
    pred = _build_predictor(model_path)
    torch.cuda.synchronize()
    parts = {"build": time.perf_counter() - t0}
    batch = np.stack([np.asarray(Image.open(f))
                      for f in sorted((root / STAGES["normalized_png"]).glob("*.png"))])
    for key in ("first_predict", "predict"):
        t0 = time.perf_counter()
        masks = pred.predict_array(batch)
        parts[key] = time.perf_counter() - t0
    sample = masks[:BREAKDOWN_MASKS].astype(np.uint8)
    t0 = time.perf_counter()
    for m in sample:
        postprocess_mask(m)
    parts["postprocess_per_mask"] = (time.perf_counter() - t0) / len(sample)
    contours = [len(cv2.findContours((m == 2).astype(np.uint8), cv2.RETR_EXTERNAL,
                                     cv2.CHAIN_APPROX_SIMPLE)[0]) for m in sample]
    log(f"[pipeline] stage 3 of the default unet, in parts: "
        f"{', '.join(f'{k} {v:.3f} s' for k, v in parts.items())} "
        f"({len(batch)} slices {batch.shape[1]}x{batch.shape[2]}, host clock); "
        f"external class-2 contours of the predicted masks it walks: {contours}")
    return dict(parts, contours=contours)


INT8_PER_FORWARD = len(INT8_CONVS)
SWEEP_BATCHES = (1, 2, 4, 8)
# whole forwards queued behind one sleep: a forward issues ~100 kernels, and
# the host blocks once about a thousand wait in the launch queue (10 queued
# forwards of unet_sa blocked it on the H100)
FORWARD_REPS = 4


def host_rate(pred, images, reps: int = 20) -> tuple:
    """(slices/s, ms per call) of ``pred.predict_array(images)``, host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_array(images)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return len(images) / dt, dt * 1e3


def int8_agreement(model, images) -> dict:
    """Masks of an int8 Predictor (bf16 compute, calibrated on the first 4
    images) and of a bf16 one, each against an f32 Predictor (TF32 off)."""
    q = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
    bf16 = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    with exact_f32():
        ref = Predictor(model, device="cuda").predict_array(images)
    masks = q.predict_array(images)
    check_masks(masks, images.shape[:3])
    return dict(int8=float((masks == ref).mean()),
                bf16=float((bf16.predict_array(images) == ref).mean()),
                shares=(np.bincount(masks.ravel(), minlength=3) / masks.size).tolist())


def int8_card_vs_cpu(model, amax: dict, images) -> float:
    """Share of pixels where an int8 Predictor in f32 on the card (TF32 off)
    and one on the CPU, both built from the calibration ``amax``, agree."""
    masks = []
    for device in ("cuda", "cpu"):
        pred = Predictor(model, device=device, quantize=True)
        pred._set_amax(amax)
        with exact_f32():
            masks.append(pred.predict_array(images))
    return float((masks[0] == masks[1]).mean())


def phase_int8_main(model, trained, profile_dir=None):
    """int8 serving of unet_s at (BATCH, HW, HW), bf16 compute: the first
    predict_array calibrates (on 4 images, the float fold's forward); then 18
    int8 launches and no bf16-kernel launch per forward, float and uint8
    images; device forward ms and host slices/s beside the bf16 Predictor's,
    batch-1 p50 / p80, peak memory.  The card's int8 masks (f32 compute,
    TF32 off) agree with the CPU's int8 masks (the kernel's plain version)
    on the same calibration on >= MIN_AGREEMENT of the pixels of 2 slices.
    Reported, not gated: int8 and bf16 masks against f32, for the random
    ``model`` on smooth noise and the ``trained`` unet_s of the train phase
    on unseen rectangle slices (the JAX scheme's own agreement there; see
    PERF.md)."""
    images = smooth_images(1, BATCH, HW)
    images_u8 = np.round(images * 255).astype(np.uint8)
    q = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
    bf16 = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    reset_launches()
    t0 = time.perf_counter()
    q.predict_array(images)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    calib = int8_counts()
    if calib != {"conv3x3_int8": INT8_PER_FORWARD, "conv3x3_nhwc": len(MAIN_CONVS)}:
        raise RuntimeError(f"the calibrating first call launched {calib}, want "
                           f"{len(MAIN_CONVS)} bf16 (calibration) and {INT8_PER_FORWARD} int8")
    bf16.predict_array(images)
    torch.cuda.synchronize()

    reset_launches()
    masks, masks_u8 = q.predict_array(images), q.predict_array(images_u8)
    launches = int8_counts()
    if launches != {"conv3x3_int8": 2 * INT8_PER_FORWARD, "conv3x3_nhwc": 0}:
        raise RuntimeError(f"two int8 forwards launched {launches}, want "
                           f"{INT8_PER_FORWARD} int8 launches each and no bf16 kernel launch")
    check_masks(masks, (BATCH, HW, HW))
    check_masks(masks_u8, (BATCH, HW, HW))
    with exact_f32():
        ref = Predictor(model, device="cuda")
        ref_masks, ref_u8 = ref.predict_array(images), ref.predict_array(images_u8)
    bf16_masks = bf16.predict_array(images)
    agree = float((masks == ref_masks).mean())
    agree_u8 = float((masks_u8 == ref_u8).mean())
    agree_bf16 = float((masks == bf16_masks).mean())
    bf16_vs_f32 = float((bf16_masks == ref_masks).mean())
    log(f"[int8-main] unet_s int8 predict_array ({BATCH}, {HW}, {HW}) bf16 compute: first call "
        f"(calibration + forward) {first_s:.3f} s, launches {calib}; then {launches} in two "
        f"forwards ({INT8_PER_FORWARD} int8 each, no bf16 kernel); random weights, smooth "
        f"noise: masks vs f32 (TF32 off) {agree:.4%} (float) / {agree_u8:.4%} (uint8); vs "
        f"bf16 {agree_bf16:.4%} (bf16 vs f32 {bf16_vs_f32:.4%})")
    rects = rect_batch(9, BATCH, HW, HW)["image"]
    trained_agree = int8_agreement(trained, rects)
    log(f"[int8-main] the trained unet_s on {BATCH} unseen rectangle slices: int8 vs f32 masks "
        f"{trained_agree['int8']:.4%}, bf16 vs f32 {trained_agree['bf16']:.4%}; int8 class "
        f"shares {trained_agree['shares']}")
    card_vs_cpu = int8_card_vs_cpu(model, q._amax, images[:2])
    log(f"[int8-main] int8 masks (f32 compute, TF32 off, one calibration) of 2 slices: card vs "
        f"CPU (the plain version) {card_vs_cpu:.4%}")
    if card_vs_cpu < MIN_AGREEMENT:
        raise RuntimeError(f"the card's int8 masks agree with the CPU's on {card_vs_cpu:.4%} < "
                           f"{MIN_AGREEMENT:.0%} of pixels")

    x = torch.from_numpy(images).cuda()
    result = dict(first_call_s=first_s, card_vs_cpu=card_vs_cpu,
                  random_agreement_f32=min(agree, agree_u8),
                  random_agreement_bf16=agree_bf16, random_bf16_agreement_f32=bf16_vs_f32,
                  trained_agreement_f32=trained_agree["int8"],
                  trained_bf16_agreement_f32=trained_agree["bf16"])
    # device forward + argmax, batch resident, queued behind a sleep (the
    # device alone): bf16, int8, int8, bf16
    with torch.inference_mode():
        fwd = {"bf16": lambda i: bf16.model(x).argmax(-1),
               "int8": lambda i: apply_int8(q._qparams, x, torch.bfloat16).argmax(-1)}
        dev = {k: [] for k in fwd}
        for k in ("bf16", "int8", "int8", "bf16"):
            dev[k].append(time_ms(fwd[k], reps=FORWARD_REPS, warmup=2)[0])
    for pred in (bf16, q):  # warm-up of the host-clock runs
        host_rate(pred, images, reps=3)
    rates = {k: [] for k in fwd}
    for k in ("bf16", "int8", "int8", "bf16"):
        torch.cuda.reset_peak_memory_stats()
        rates[k].append(host_rate(bf16 if k == "bf16" else q, images)[0])
        result[f"{k}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    lat = []
    one = images[:1]
    for _ in range(3):
        q.predict_array(one)
    for _ in range(50):
        t1 = time.perf_counter()
        q.predict_array(one)
        lat.append((time.perf_counter() - t1) * 1e3)
    p50, p80 = np.percentile(lat, [50, 80])
    if profile_dir:
        profile_forward(lambda: apply_int8(q._qparams, x, torch.bfloat16).argmax(-1),
                        Path(profile_dir), "int8_predict")
    for k in ("bf16", "int8"):
        result[f"{k}_forward_ms"] = float(np.mean(dev[k]))
        result[f"{k}_slices_per_s"] = float(np.mean(rates[k]))
    result.update(int8_forward_ms_runs=dev["int8"], bf16_forward_ms_runs=dev["bf16"],
                  int8_slices_per_s_runs=rates["int8"], bf16_slices_per_s_runs=rates["bf16"],
                  int8_latency_p50_ms=p50, int8_latency_p80_ms=p80)
    log(f"[int8-main] device forward+argmax per batch of {BATCH} (CUDA events, batch resident, "
        f"{FORWARD_REPS} calls queued behind a sleep): "
        f"int8 {dev['int8']} ms, bf16 {dev['bf16']} ms (int8 / bf16 "
        f"{result['int8_forward_ms'] / result['bf16_forward_ms']:.3f}); host slices/s int8 "
        f"{rates['int8']}, bf16 {rates['bf16']}; int8 batch-1 latency p50 {p50:.3f} ms, p80 "
        f"{p80:.3f} ms (50 calls); peak memory int8 {result['int8_peak_mib']:.1f} MiB, bf16 "
        f"{result['bf16_peak_mib']:.1f} MiB")
    return launches, result


def phase_int8_sweep():
    """INT8_MIN_BATCH on the card: device forward ms (CUDA events, calls
    queued behind a sleep, batch resident) of the int8 and the bf16 forward
    of unet_s and unet_sa at b = 1, 2, 4, 8 at 512²."""
    out = {}
    for name, factory in (("unet_s", unet_s), ("unet_sa", unet_sa)):
        model = build_model(MODEL_SEED, factory)
        q = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
        q.calibrate(smooth_images(1, 4, HW))
        rows = {}
        with torch.inference_mode():
            for b in SWEEP_BATCHES:
                x = torch.from_numpy(smooth_images(2, b, HW)).cuda()
                int8_ms, _ = time_ms(lambda i: apply_int8(q._qparams, x, torch.bfloat16),
                                     reps=FORWARD_REPS, warmup=2)
                bf16_ms, _ = time_ms(lambda i: q.model(x), reps=FORWARD_REPS, warmup=2)
                rows[b] = dict(int8_ms=int8_ms, bf16_ms=bf16_ms, ratio=int8_ms / bf16_ms)
        out[name] = rows
        log(f"[int8-sweep] {name} (b, int8 ms, bf16 ms, int8 / bf16): "
            + "; ".join(f"{b}: {r['int8_ms']:.3f}, {r['bf16_ms']:.3f}, {r['ratio']:.3f}"
                        for b, r in rows.items())
            + f"; INT8_MIN_BATCH {Predictor.INT8_MIN_BATCH.get(name, 1)}")
    return out


def phase_int8_tiled(model):
    """Tiled int8 serving of unet_s at (2, 2048, 2048), bf16 compute, auto
    tile 512, halo HALO: the first call calibrates (dense, on both images);
    then 18 int8 launches per window-group forward and no bf16-kernel launch;
    the tiled int8 masks agree with the dense int8 ones (one calibration) on
    >= MIN_AGREEMENT of the interior (>= HALO from the border); against the
    bf16 tiled masks reported; host slices/s and device ms per image beside
    bf16 tiled."""
    n, s = TILED_SIZES[0]
    images = smooth_images(21, n, s, cells=s // 32)
    q = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, tile_halo=HALO,
                  quantize=True)
    bf16 = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, tile_halo=HALO)
    q.predict_array(images)
    want = bf16.predict_array(images)
    torch.cuda.synchronize()
    reset_launches()
    masks = q.predict_array(images)
    launches = int8_counts()
    forwards = group_forwards(q, n, s, s)
    if launches != {"conv3x3_int8": INT8_PER_FORWARD * forwards, "conv3x3_nhwc": 0}:
        raise RuntimeError(f"{forwards} tiled int8 group forwards launched {launches}, want "
                           f"{INT8_PER_FORWARD} int8 each and no bf16 kernel launch")
    check_masks(masks, (n, s, s))
    dense = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, tile_threshold=0,
                      quantize=True)
    dense._set_amax(q._amax)
    inner = float((interior(masks) == interior(dense.predict_array(images))).mean())
    agree = float((masks == want).mean())
    if inner < MIN_AGREEMENT:
        raise RuntimeError(f"tiled int8 masks agree with dense int8 on {inner:.4%} < "
                           f"{MIN_AGREEMENT:.0%} of the interior")
    x = torch.from_numpy(images[..., None]).cuda()
    tile = q._auto_tile(s, s)
    result = dict(interior_agreement_dense=inner, agreement_bf16=agree, forwards=forwards)
    for k, pred in (("bf16", bf16), ("int8", q), ("int8", q), ("bf16", bf16)):
        dev_ms, _ = time_ms(lambda i: pred._tile_grid(x, tile, HALO), reps=TILED_REPS,
                            warmup=2, queued=False)
        rate, _ = host_rate(pred, images, reps=TILED_REPS)
        result.setdefault(f"{k}_device_ms_per_image", []).append(dev_ms / n)
        result.setdefault(f"{k}_slices_per_s", []).append(rate)
    log(f"[int8-tiled] unet_s ({n}, {s}, {s}) tile {tile}: {forwards} window-group forwards, "
        f"{launches}; masks vs dense int8 (interior) {inner:.4%}, vs bf16 tiled {agree:.4%}; "
        f"device ms per image int8 "
        f"{result['int8_device_ms_per_image']}, bf16 {result['bf16_device_ms_per_image']}; "
        f"host slices/s int8 {result['int8_slices_per_s']}, bf16 {result['bf16_slices_per_s']}")
    return launches, result


def phase_int8_pipeline():
    """run_pipeline with cfg.int8 on the PIPE_SCANS RAW scans, injected unet_s
    (a fresh quantize=True Predictor each run), twice into one int8_scales
    JSON: run A calibrates (one bf16 calibration forward) and writes it,
    run B loads it (no bf16 launch); the stage-3 masks of the two runs are
    equal.  Needs PIL and cv2 (phase 9 says whether they import)."""
    if None in host_libraries().values():
        log("[int8-pipeline] PIL or cv2 is missing on this machine: not run")
        return {}, {}
    from PIL import Image

    model = build_model(MODEL_SEED, unet_s, class2_share=0.6)
    result, total = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "raws").mkdir()
        write_raw_scans(tmp / "raws", 31, PIPE_SCANS, PIPE_W, PIPE_H)
        scales = tmp / "scales.json"
        batches = -(-PIPE_SCANS // 8)
        for run, calib in (("a", len(MAIN_CONVS)), ("b", 0)):
            pred = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
            cfg = PipelineConfig(input_raw=str(tmp / "raws"), output_root=str(tmp / run),
                                 width=PIPE_W, height=PIPE_H, target_size=PIPE_TARGET,
                                 int8=True, int8_scales=str(scales), **PIPE_WINDOW)
            reset_launches()
            _, stages, seconds = run_timed(cfg, pred)
            launches = int8_counts()
            want = {"conv3x3_int8": batches * INT8_PER_FORWARD, "conv3x3_nhwc": calib}
            if launches != want or not scales.exists():
                raise RuntimeError(f"int8 pipeline run {run} launched {launches}, want {want}; "
                                   f"scales written: {scales.exists()}")
            n_json, n_poly = check_results(tmp / run)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            result[run] = dict(seconds=seconds, stage_seconds=stages, json_files=n_json,
                               polygons=n_poly, launches=launches)
            log(f"[int8-pipeline] run {run}: {n_json} labelme JSON files, {n_poly} polygons, "
                f"{seconds:.3f} s (stage seconds "
                f"{' '.join(f'{k}: {v:.3f}' for k, v in sorted(stages.items()))}); {launches}")
        masks = [{p.name: np.asarray(Image.open(p)) for p in (tmp / r / STAGES["pred_masks"])
                  .glob("*.png")} for r in ("a", "b")]
        if masks[0].keys() != masks[1].keys() or any(
                not np.array_equal(masks[0][k], masks[1][k]) for k in masks[0]):
            raise RuntimeError("the int8 pipeline's second run (scales loaded) wrote other "
                               "stage-3 masks than the first (scales calibrated)")
    log(f"[int8-pipeline] run b loaded run a's scales; its {len(masks[0])} stage-3 masks "
        f"equal run a's")
    return total, result


def phase_export(model) -> tuple:
    """B1: unet_s (bf16) as a torch.export program with a dynamic batch and
    H, W (engine/export.py), saved as .pt2 and loaded by ExportedPredictor:
    predict_array on (BATCH, HW, HW) and on one 1024x768 image through the
    same program.  7 launches per forward through the operator; masks >=
    99.9% equal to the live Predictor's; host slices/s beside the live
    predictor's."""
    from unet_medical_image_contour_segmentation_torch.engine.export import export_program
    from unet_medical_image_contour_segmentation_torch.engine.predict import (
        ExportedPredictor,
    )

    net = unet_s(compute_dtype=torch.bfloat16)
    net.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    data = export_program(net.eval(), device="cuda")
    export_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "unet_s.pt2")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        exported = ExportedPredictor.from_file(path, device="cuda")
        load_s = time.perf_counter() - t0
    live = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    images = smooth_images(1, BATCH, HW)
    wide = smooth_images(13, 1, 1024)[:, :, :768]
    exported.predict_array(images[:1])  # warm-up
    reset_launches()
    masks = exported.predict_array(images)
    masks_wide = exported.predict_array(wide)
    launches = read_launches()
    want = fwd_launches(2 * len(MAIN_CONVS), 2 * UNET_PASSES)
    agree = float((masks == live.predict_array(images)).mean())
    agree_wide = float((masks_wide == live.predict_array(wide)).mean())
    check_masks(masks, (BATCH, HW, HW))
    check_masks(masks_wide, (1, 1024, 768))
    if launches != want or min(agree, agree_wide) < MIN_EXPORT_AGREEMENT:
        raise RuntimeError(f"[B1 export] two program forwards launched {launches} (want "
                           f"{want}); masks agree with the live Predictor's on {agree:.6%} "
                           f"(8x512²) and {agree_wide:.6%} (1024x768)")
    for pred in (exported, live):
        for _ in range(3):
            pred.predict_array(images)
    rate, ms = host_rate(exported, images)
    live_rate, live_ms = host_rate(live, images)
    log(f"[B1 export] unet_s bf16 program: export {export_s:.1f} s, {len(data)} bytes, load "
        f"{load_s:.2f} s; {len(MAIN_CONVS)} kernel launches per forward through "
        f"umics::conv3x3_nhwc ({launches}); masks equal to the live Predictor's on "
        f"{agree:.6%} of ({BATCH}, {HW}, {HW}) and {agree_wide:.6%} of one 1024x768 image "
        f"(the same program); host {rate:.1f} slices/s ({ms:.3f} ms a batch) against the "
        f"live Predictor's {live_rate:.1f} ({live_ms:.3f} ms)")
    return launches, dict(export_s=export_s, load_s=load_s, bytes=len(data), agreement=agree,
                          agreement_1024x768=agree_wide, slices_per_s=rate,
                          live_slices_per_s=live_rate)


def phase_export_int8(model) -> tuple:
    """B2: the int8 program at 512² from a calibration JSON (export_program_int8):
    18 int8 and no bf16 launch per forward; masks 100% equal to the live int8
    Predictor's on the same qparams."""
    from unet_medical_image_contour_segmentation_torch.engine.export import (
        export_program_int8,
    )
    from unet_medical_image_contour_segmentation_torch.engine.predict import (
        ExportedPredictor,
    )

    images = smooth_images(1, BATCH, HW)
    net = unet_s(compute_dtype=torch.bfloat16)
    net.load_state_dict(model.state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        scales = os.path.join(tmp, "scales.json")
        calib = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
        calib.calibrate(images[:4])
        calib.save_calibration(scales)
        live = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
        live.load_calibration(scales)
    data = export_program_int8(net.eval(), live._qparams, example_hw=(HW, HW))
    exported = ExportedPredictor(data, device="cuda")
    exported.predict_array(images[:1])  # warm-up
    reset_launches()
    masks = exported.predict_array(images)
    launches = int8_counts()
    want_masks = live.predict_array(images)
    agree = float((masks == want_masks).mean())
    check_masks(masks, (BATCH, HW, HW))
    if launches != {"conv3x3_int8": INT8_PER_FORWARD, "conv3x3_nhwc": 0} or agree != 1.0:
        raise RuntimeError(f"[B2 export int8] one program forward launched {launches} (want "
                           f"{INT8_PER_FORWARD} int8, 0 bf16); masks equal to the live int8 "
                           f"Predictor's on {agree:.6%}")
    for pred in (exported, live):
        pred.predict_array(images)
    rate, _ = host_rate(exported, images)
    live_rate, _ = host_rate(live, images)
    log(f"[B2 export int8] unet_s int8 program at {HW}² from a scales JSON ({len(data)} "
        f"bytes): {launches} per forward; masks equal to the live int8 Predictor's on "
        f"{agree:.4%}; host {rate:.1f} slices/s against the live int8 Predictor's "
        f"{live_rate:.1f}")
    return launches, dict(bytes=len(data), agreement=agree, slices_per_s=rate,
                          live_slices_per_s=live_rate)


# -- C1-C4: UNet++ and YOLOv8-seg at the presets' full widths -------------------

# routed 3x3 convs per forward (the dispatch rule, confirmed by routed_convs):
# unet_pp_s 12 (its bilinear variant 11), the full unet_pp 0, yolov8_seg_s 4
PP_PER_FORWARD, YOLO_PER_FORWARD = 12, 4
# every DoubleConv conv of unet_pp_s runs int8: 15 nodes x 2
PP_INT8_PER_FORWARD = 30
# the int8 forward's nested conv1s as split inputs (x: the j skips
# concatenated, x2: the ConvTranspose upsample): name, Cin, Cin2, Cout,
# downsampling of the level (unet_pp_s widths 16..128)
PP_SPLIT_CONVS = [(f"x{i}_{j}.conv1", w * j, w, w, 2 ** i)
                  for j in range(1, 5) for i, w in enumerate((16, 32, 64, 128)) if i + j <= 4]
# the card-vs-CPU int8 check of unet_pp_s runs the plain int8 conv (an f64
# im2col product) on the CPU: 2 images cut to this size keep it to seconds
PP_INT8_CPU_HW = 256
# yolov8_seg_s int8 (C5), launches per forward: the proto scope runs p_c1..3
# on the int8 kernel and c2f0's bottleneck (its folded float convs, 32->32)
# on the bf16 kernel; the full scope runs its 20 bottleneck convs and
# p_c1..3 on the int8 kernel and nothing on the bf16 one
YOLO_INT8_PROTO, YOLO_BF16_PROTO = len(YOLO_PROTO_CONVS), 2
YOLO_INT8_FULL = sum(n for *_, n in YOLO_SILU_CONVS)
# card-vs-CPU int8 masks of yolov8_seg_s (f32 compute, TF32 off): the two
# float backbones differ in f32 rounding, and a p_c input's quantise step
# can then land one LSB apart at a .5 tie
MIN_YOLO_CARD_VS_CPU = 0.9999


def fwd_launches(n: int, passes: int) -> dict:
    """The read_launches() of n forward launches on the tensor cores, no dx,
    and ``passes`` launches of the one-pass bias + ReLU."""
    return {"conv3x3_nhwc": n, "conv3x3_nhwc.tensor_core": n, "conv3x3_nhwc_dx": 0,
            "conv3x3_nhwc_dx.tensor_core": 0, "bias_relu_nhwc": passes}


def in_dtype(model, dtype):
    """A copy of ``model`` whose convs run in ``dtype`` (f32 master weights)."""
    import copy

    net = copy.deepcopy(model)
    net.compute_dtype = dtype
    return net


def counted_masks(pred, images, want: dict, label: str) -> np.ndarray:
    """``pred.predict_array(images)`` in a counted window, which must launch
    ``want`` (read_launches); -> the masks."""
    reset_launches()
    masks = pred.predict_array(images)
    launches = read_launches()
    if launches != want:
        raise RuntimeError(f"[{label}] predict_array{tuple(images.shape)} launched {launches}, "
                           f"want {want}")
    return masks


def serve_numbers(pred, images, queued_reps: int = FORWARD_REPS) -> dict:
    """Host slices/s of ``pred.predict_array(images)`` (20 calls, host arrays
    in and out), batch-1 p50 (50 calls), device forward + classes ms (the
    Predictor's own forward, int8 where it serves int8; CUDA events, batch
    resident, ``queued_reps`` calls queued behind a sleep: the device alone)
    and peak memory of the host-clock calls."""
    for _ in range(3):
        pred.predict_array(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rate, batch_ms = host_rate(pred, images)
    peak = torch.cuda.max_memory_allocated() / 2**20
    one = images[:1]
    for _ in range(3):
        pred.predict_array(one)
    lat = []
    for _ in range(50):
        t1 = time.perf_counter()
        pred.predict_array(one)
        lat.append((time.perf_counter() - t1) * 1e3)
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        fwd_ms, _ = time_ms(lambda i: pred._classes(pred._logits(x)), reps=queued_reps,
                            warmup=2)
    return dict(slices_per_s=rate, batch_ms=batch_ms, latency_p50_ms=float(np.median(lat)),
                forward_ms=fwd_ms, peak_mib=peak)


def phase_pp_serve():
    """C1: unet_pp_s (3 classes, ConvTranspose ups) with seeded weights served
    by Predictor at (BATCH, HW, HW) in bf16: 12 kernel launches a forward,
    masks against f32 (TF32 off) >= MIN_AGREEMENT, host slices/s, batch-1
    p50, device forward ms, peak memory; one bf16 forward of the full
    unet_pp (64..1024) at the same batch for its peak memory (no kernel
    launch); one 2048² scan tiled (auto tile 512), 12 launches per
    window-group forward, tiled against dense in the interior (bf16 >=
    MIN_AGREEMENT, f32 >= MIN_INTERIOR_AGREEMENT)."""
    model = seeded_model("unet_pp_s", MODEL_SEED, n_classes=3)
    if len(routed_convs(model)) != PP_PER_FORWARD:
        raise RuntimeError(f"unet_pp_s routes {routed_convs(model)}, not {PP_PER_FORWARD} convs")
    images = smooth_images(1, BATCH, HW)
    pred = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    pred.predict_array(images[:1])  # warm-up: cuDNN picks its algorithms here
    masks = counted_masks(pred, images, fwd_launches(PP_PER_FORWARD, PP_PASSES),
                          "C1 unet_pp_s predict")
    check_masks(masks, (BATCH, HW, HW))
    with exact_f32():
        ref = Predictor(model, device="cuda").predict_array(images)
    agree = float((masks == ref).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"[C1] unet_pp_s bf16 masks agree with f32 on {agree:.4%} < "
                           f"{MIN_AGREEMENT:.0%}")
    result = dict(agreement_f32=agree, **serve_numbers(pred, images),
                  shares=(np.bincount(masks.ravel(), minlength=3) / masks.size).tolist())
    log(f"[C1 unet_pp_s] bf16 predict_array ({BATCH}, {HW}, {HW}): {PP_PER_FORWARD} kernel "
        f"launches a forward, all on the tensor cores; masks vs f32 (TF32 off) {agree:.4%}, "
        f"class shares {result['shares']}; {result['slices_per_s']:.1f} slices/s "
        f"({result['batch_ms']:.3f} ms a batch, host clock), batch-1 p50 "
        f"{result['latency_p50_ms']:.3f} ms, device forward+argmax {result['forward_ms']:.3f} ms "
        f"(CUDA events, {FORWARD_REPS} calls queued), peak memory {result['peak_mib']:.1f} MiB")

    full = Predictor(seeded_model("unet_pp", MODEL_SEED, centre=False, n_classes=3),
                     device="cuda", compute_dtype=torch.bfloat16)
    full.predict_array(images[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check_masks(counted_masks(full, images, fwd_launches(0, PP_PASSES),
                                      "C1 unet_pp predict"),
                (BATCH, HW, HW))
    full_peak = torch.cuda.max_memory_allocated() / 2**20
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        full_ms, _ = time_ms(lambda i: full.model(x).argmax(-1), reps=3, warmup=1, queued=False)
    del full, x
    torch.cuda.empty_cache()
    result.update(unet_pp_peak_mib=full_peak, unet_pp_forward_ms=full_ms)
    log(f"[C1 unet_pp] the full unet_pp (64..1024) bf16 predict_array ({BATCH}, {HW}, {HW}): "
        f"no kernel launch (every 3x3 conv has Cin >= 64 but x0_0.conv1's 1), peak memory "
        f"{full_peak:.1f} MiB, device forward+argmax {full_ms:.3f} ms")

    n, s = 1, TILED_SIZES[0][1]
    scan = smooth_images(21, n, s, cells=s // 32)
    tiled = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, tile_halo=HALO)
    dense = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, tile_threshold=0)
    tiled.predict_array(scan)  # warm-up
    forwards = group_forwards(tiled, n, s, s)
    t_masks = counted_masks(tiled, scan,
                            fwd_launches(PP_PER_FORWARD * forwards, PP_PASSES * forwards),
                            "C1 unet_pp_s tiled")
    inner = float((interior(t_masks) == interior(dense.predict_array(scan))).mean())
    with exact_f32():
        f32_t = Predictor(model, device="cuda", tile_halo=HALO).predict_array(scan)
        f32_d = Predictor(model, device="cuda", tile_threshold=0).predict_array(scan)
    inner_f32 = float((interior(f32_t) == interior(f32_d)).mean())
    if inner < MIN_AGREEMENT or inner_f32 < MIN_INTERIOR_AGREEMENT:
        raise RuntimeError(f"[C1 tiled] tiled vs dense interior {inner:.4%} (bf16) / "
                           f"{inner_f32:.4%} (f32)")
    rate, call_ms = host_rate(tiled, scan, reps=TILED_REPS)
    tile = tiled._auto_tile(s, s)
    xs = torch.from_numpy(scan[..., None]).cuda()
    dev_ms, _ = time_ms(lambda i: tiled._tile_grid(xs, tile, HALO), reps=TILED_REPS, warmup=2,
                        queued=False)
    result["tiled"] = dict(forwards=forwards, interior_agreement_dense=inner,
                           interior_agreement_dense_f32=inner_f32, slices_per_s=rate,
                           call_ms=call_ms, device_ms_per_image=dev_ms / n)
    log(f"[C1 unet_pp_s tiled] ({n}, {s}, {s}) tile {tile}, halo {HALO}: {forwards} "
        f"window-group forwards of {PP_PER_FORWARD} launches; tiled vs dense interior "
        f"{inner:.4%} (bf16), {inner_f32:.4%} (f32); {rate:.3f} slices/s ({call_ms:.2f} ms a "
        f"call, host clock), device {dev_ms / n:.3f} ms per image")
    return model, {"pp_predict": fwd_launches(PP_PER_FORWARD, PP_PASSES),
                   "pp_tiled": fwd_launches(PP_PER_FORWARD * forwards,
                                            PP_PASSES * forwards)}, result


def phase_pp_int8(model):
    """C2: unet_pp_s int8 (bf16 compute) at (BATCH, HW, HW): the first call
    calibrates (a bf16 forward of 12 launches, then 30 int8); then 30 int8
    launches and no bf16-kernel launch a forward; int8 masks of the card
    (f32 compute, TF32 off) against the CPU's (the kernel's plain version)
    on one calibration >= MIN_AGREEMENT, as the UNet's int8 is held; device
    forward ms int8 against bf16 (bf16, int8, int8, bf16), host slices/s;
    masks against f32 reported.  Then the int8 .pt2 program at 512² from
    the live qparams: 30 int8 launches a forward, masks 100% equal to the
    live int8 Predictor's."""
    from unet_medical_image_contour_segmentation_torch.engine.export import (
        export_program_int8,
    )
    from unet_medical_image_contour_segmentation_torch.engine.predict import (
        ExportedPredictor,
    )

    images = smooth_images(1, BATCH, HW)
    q = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
    bf16 = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    reset_launches()
    q.predict_array(images)
    calib = int8_counts()
    if calib != {"conv3x3_int8": PP_INT8_PER_FORWARD, "conv3x3_nhwc": PP_PER_FORWARD}:
        raise RuntimeError(f"[C2] the calibrating first call launched {calib}")
    reset_launches()
    masks = q.predict_array(images)
    launches = int8_counts()
    if launches != {"conv3x3_int8": PP_INT8_PER_FORWARD, "conv3x3_nhwc": 0}:
        raise RuntimeError(f"[C2] an int8 forward launched {launches}, want "
                           f"{PP_INT8_PER_FORWARD} int8 and no bf16 kernel launch")
    check_masks(masks, (BATCH, HW, HW))
    with exact_f32():
        ref = Predictor(model, device="cuda").predict_array(images)
    agree, agree_bf16 = float((masks == ref).mean()), float((bf16.predict_array(images) == ref)
                                                            .mean())
    cut = images[:2, :PP_INT8_CPU_HW, :PP_INT8_CPU_HW]
    card_vs_cpu = int8_card_vs_cpu(model, q._amax, cut)
    if card_vs_cpu < MIN_AGREEMENT:
        raise RuntimeError(f"[C2] the card's int8 masks agree with the CPU's on "
                           f"{card_vs_cpu:.4%} < {MIN_AGREEMENT:.0%}")
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        fwd = {"bf16": lambda i: bf16.model(x).argmax(-1),
               "int8": lambda i: apply_int8(q._qparams, x, torch.bfloat16).argmax(-1)}
        dev = {k: [] for k in fwd}
        for k in ("bf16", "int8", "int8", "bf16"):
            dev[k].append(time_ms(fwd[k], reps=FORWARD_REPS, warmup=2)[0])
    rates = {k: host_rate(p, images, reps=10)[0] for k, p in (("bf16", bf16), ("int8", q))}
    result = dict(agreement_f32=agree, bf16_agreement_f32=agree_bf16, card_vs_cpu=card_vs_cpu,
                  int8_forward_ms=float(np.mean(dev["int8"])),
                  bf16_forward_ms=float(np.mean(dev["bf16"])), int8_forward_ms_runs=dev["int8"],
                  bf16_forward_ms_runs=dev["bf16"], int8_slices_per_s=rates["int8"],
                  bf16_slices_per_s=rates["bf16"])
    log(f"[C2 unet_pp_s int8] ({BATCH}, {HW}, {HW}) bf16 compute: calibration {calib}, then "
        f"{launches} a forward; masks vs f32 {agree:.4%} (bf16 vs f32 {agree_bf16:.4%}); card "
        f"vs CPU int8 masks (f32 compute, {tuple(cut.shape)}) {card_vs_cpu:.4%}; device "
        f"forward+argmax int8 {dev['int8']} ms, bf16 {dev['bf16']} ms (int8 / bf16 "
        f"{result['int8_forward_ms'] / result['bf16_forward_ms']:.3f}, CUDA events, "
        f"{FORWARD_REPS} calls queued); host slices/s int8 {rates['int8']:.1f}, bf16 "
        f"{rates['bf16']:.1f}")

    t0 = time.perf_counter()
    data = export_program_int8(in_dtype(model, torch.bfloat16).eval(), q._qparams,
                               example_hw=(HW, HW))
    export_s = time.perf_counter() - t0
    exported = ExportedPredictor(data, device="cuda")
    exported.predict_array(images[:1])  # warm-up
    reset_launches()
    e_masks = exported.predict_array(images)
    e_launches = int8_counts()
    e_agree = float((e_masks == q.predict_array(images)).mean())
    if e_launches != {"conv3x3_int8": PP_INT8_PER_FORWARD, "conv3x3_nhwc": 0} or e_agree != 1.0:
        raise RuntimeError(f"[C2 export int8] a program forward launched {e_launches}; masks "
                           f"equal to the live int8 Predictor's on {e_agree:.6%}")
    result["export"] = dict(bytes=len(data), export_s=export_s, agreement=e_agree,
                            slices_per_s=host_rate(exported, images, reps=10)[0])
    log(f"[C2 unet_pp_s int8 export] program at {HW}² ({len(data)} bytes, export "
        f"{export_s:.1f} s): {e_launches} a forward; masks equal to the live int8 "
        f"Predictor's on {e_agree:.4%}; host {result['export']['slices_per_s']:.1f} slices/s")
    return {"pp_int8_predict": launches, "pp_int8_export": e_launches}, result


def phase_pp_train():
    """C3: unet_pp_s trains multiclass: one f32 step card vs CPU (as phase 6),
    then TRAIN_WARMUP + TRAIN_STEPS bf16 steps at (BATCH, HW, HW), 12 + 12
    launches a step, a falling loss, step ms; a remat step against a plain
    one from the same weights (remat_equals_plain: 24 + 12 launches), peak
    memory both ways."""
    def build(**kw):
        return seeded_model("unet_pp_s", MODEL_SEED, centre=False, n_classes=3, **kw)

    phase_train_reference(3, build=build, label="C3 unet_pp_s train-reference")
    launches, numbers, _ = train_steps(build(compute_dtype=torch.bfloat16).cuda(), LossConfig(),
                                       device_batch(6), "C3 unet_pp_s train", PP_PER_FORWARD)
    batch = device_batch(9)
    runs = {remat: remat_step(build(compute_dtype=torch.bfloat16, remat=remat).cuda(), batch)
            for remat in (False, True)}
    loss_err, grad_err = remat_equals_plain(runs, PP_PER_FORWARD, "C3 unet_pp_s remat")
    numbers.update(remat_loss_rel=loss_err, remat_grad_err=grad_err,
                   plain_peak_mib=runs[False][3], remat_peak_mib=runs[True][3],
                   plain_step_ms=runs[False][5], remat_step_ms=runs[True][5])
    log(f"[C3 unet_pp_s remat] bf16 ({BATCH}, {HW}, {HW}): remat step loss rel {loss_err:.3g}, "
        f"gradients {grad_err:.3g} of the largest, BN buffers bit-equal, launches "
        f"{runs[True][4]}; peak memory remat {runs[True][3]:.1f} MiB, plain "
        f"{runs[False][3]:.1f} MiB ({runs[True][3] / runs[False][3]:.3f}x); step "
        f"{runs[True][5]:.3f} ms remat, {runs[False][5]:.3f} ms plain")
    return {"pp_train": launches, "pp_train_remat": runs[True][4]}, numbers


def phase_yolo():
    """C4: yolov8_seg_s (1 class, binary) with seeded weights: live-BN serving
    in bf16 at (BATCH, HW, HW), 4 launches a forward, masks against f32 >=
    MIN_AGREEMENT, host slices/s, device forward ms, peak memory; one f32
    binary step card vs CPU, then TRAIN_WARMUP + TRAIN_STEPS bf16 binary
    steps, 4 + 4 launches a step, a falling loss; a bf16 .pt2 program
    (dynamic batch, H and W multiples of 32) served at (BATCH, HW, HW) and
    one 1024x768 image, 4 launches a forward, masks >= MIN_EXPORT_AGREEMENT
    of the live Predictor's."""
    from unet_medical_image_contour_segmentation_torch.engine.export import export_program
    from unet_medical_image_contour_segmentation_torch.engine.predict import (
        ExportedPredictor,
    )

    model = seeded_model("yolov8_seg_s", MODEL_SEED)
    if len(routed_convs(model)) != YOLO_PER_FORWARD:
        raise RuntimeError(f"yolov8_seg_s routes {routed_convs(model)}")
    images = smooth_images(1, BATCH, HW)
    pred = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    pred.predict_array(images[:1])
    masks = counted_masks(pred, images, fwd_launches(YOLO_PER_FORWARD, 0), "C4 yolo predict")
    if masks.shape != (BATCH, HW, HW) or not set(np.unique(masks)) <= {0, 1}:
        raise RuntimeError(f"[C4] masks {masks.shape} with values {np.unique(masks)}")
    with exact_f32():
        ref = Predictor(model, device="cuda").predict_array(images)
    agree = float((masks == ref).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"[C4] yolov8_seg_s bf16 masks agree with f32 on {agree:.4%}")
    # one forward queued at a time: four queued yolov8_seg_s forwards fill the
    # launch queue on an H100 and block the host past the sleep
    serve = dict(agreement_f32=agree, foreground=float(masks.mean()),
                 **serve_numbers(pred, images, queued_reps=1))
    log(f"[C4 yolov8_seg_s] bf16 predict_array ({BATCH}, {HW}, {HW}), live BN: "
        f"{YOLO_PER_FORWARD} kernel launches a forward; masks vs f32 {agree:.4%} (foreground "
        f"{serve['foreground']:.3f}); {serve['slices_per_s']:.1f} slices/s, batch-1 p50 "
        f"{serve['latency_p50_ms']:.3f} ms, device forward+classes {serve['forward_ms']:.3f} ms "
        f"(CUDA events, one call queued), peak memory {serve['peak_mib']:.1f} MiB")

    def build(**kw):
        return seeded_model("yolov8_seg_s", MODEL_SEED, centre=False, **kw)

    phase_train_reference(1, build=build, label="C4 yolov8_seg_s binary train-reference")
    t_launches, train, _ = train_steps(build(compute_dtype=torch.bfloat16).cuda(),
                                       LossConfig(n_classes=1), device_batch(6),
                                       "C4 yolov8_seg_s binary train", YOLO_PER_FORWARD)

    t0 = time.perf_counter()
    data = export_program(in_dtype(model, torch.bfloat16).eval(), device="cuda")
    export_s = time.perf_counter() - t0
    exported = ExportedPredictor(data, device="cuda")
    wide = smooth_images(13, 1, EXPORT_WIDE[0])[:, :, :EXPORT_WIDE[1]]
    exported.predict_array(images[:1])  # warm-up
    reset_launches()
    e_masks, e_wide = exported.predict_array(images), exported.predict_array(wide)
    e_launches = read_launches()
    e_agree = float((e_masks == pred.predict_array(images)).mean())
    e_agree_wide = float((e_wide == pred.predict_array(wide)).mean())
    if (e_launches != fwd_launches(2 * YOLO_PER_FORWARD, 0) or e_wide.shape != (1, *EXPORT_WIDE)
            or min(e_agree, e_agree_wide) < MIN_EXPORT_AGREEMENT):
        raise RuntimeError(f"[C4 export] two program forwards launched {e_launches}; masks "
                           f"agree with the live Predictor's on {e_agree:.6%} and "
                           f"{e_agree_wide:.6%}")
    export = dict(bytes=len(data), export_s=export_s, agreement=e_agree,
                  agreement_1024x768=e_agree_wide,
                  slices_per_s=host_rate(exported, images, reps=10)[0])
    log(f"[C4 yolov8_seg_s export] bf16 program ({len(data)} bytes, export {export_s:.1f} s): "
        f"{YOLO_PER_FORWARD} launches a forward ({e_launches} in two); masks equal to the live "
        f"Predictor's on {e_agree:.6%} of ({BATCH}, {HW}, {HW}) and {e_agree_wide:.6%} of one "
        f"1024x768 image; host {export['slices_per_s']:.1f} slices/s")
    return ({"yolo_predict": fwd_launches(YOLO_PER_FORWARD, 0), "yolo_train": t_launches,
             "yolo_export": e_launches}, dict(serve=serve, train=train, export=export))


def int_mm_bound_ms(t: torch.Tensor, wm: torch.Tensor, k: int, stride: int) -> tuple:
    """(ms, "bytes" | "operations") of one ``_int8_conv_sums`` call: int8 x
    and the (N, K) int8 weight read once, the int32 sums written once,
    against 2 * k*k*Cin * N operations per output pixel at the int8 peak."""
    b, h, w, cin = t.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    n = wm.shape[0]
    nbytes = t.numel() + wm.numel() + b * ho * wo * n * 4
    ops = 2 * b * ho * wo * k * k * cin * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[torch.int8] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_mm_route_ms(qparams: dict, x: torch.Tensor) -> tuple:
    """The int8 1x1 and stride-2 convs of one full-scope int8 forward
    (``models/quantize.py:_int8_conv_sums``: the im2col rows and
    ``torch._int_mm``): each call's input recorded in one forward, then
    each call timed alone on copies rotated past the L2, queued behind a
    sleep; -> (the sum of their device ms, the number of calls, the sum of
    their bounds, what binds the most of that sum)."""
    calls, sums = [], quantize_module._int8_conv_sums

    def recorded(t, wm, k, stride):
        calls.append((t.clone(), wm, k, stride))
        return sums(t, wm, k, stride)

    quantize_module._int8_conv_sums = recorded
    try:
        with torch.inference_mode():
            apply_int8(qparams, x, torch.bfloat16)
    finally:
        quantize_module._int8_conv_sums = sums
    total, bound, by = 0.0, 0.0, {"bytes": 0.0, "operations": 0.0}
    with torch.inference_mode():
        for t, wm, k, stride in calls:
            ts = copies(t)
            total += time_ms(lambda i: sums(ts[i % len(ts)], wm, k, stride), reps=10)[0]
            del ts
            ms, kind = int_mm_bound_ms(t, wm, k, stride)
            bound += ms
            by[kind] += ms
    return total, len(calls), bound, max(by, key=by.get)


def phase_yolo_int8(profile_dir=None):
    """C5: yolov8_seg_s (1 class, binary) int8 with seeded weights, bf16
    compute, at (BATCH, HW, HW).  The proto scope (the Predictor's): the
    first call calibrates on the CBS fold (YOLO_PER_FORWARD bf16 launches)
    and serves; then YOLO_INT8_PROTO int8 and YOLO_BF16_PROTO bf16 launches a
    forward; the card's int8 masks (f32 compute, TF32 off) against the
    CPU's on one calibration >= MIN_YOLO_CARD_VS_CPU; masks against f32
    reported; device forward int8 against bf16 (live BN, as served) and
    against the BN-folded bf16 forward, one call queued at a time;
    host slices/s and batch-1 p50.  The full scope from the same
    calibration (``build_qparams_yolo(scope="full")``): YOLO_INT8_FULL int8
    launches and no bf16 one, masks against f32, the device forward, and
    the time of its ``torch._int_mm`` route.  Then the int8 .pt2 program
    of the proto qparams at 512²: the Predictor's launches, masks 100% equal
    to the live int8 Predictor's."""
    from unet_medical_image_contour_segmentation_torch.engine.export import (
        export_program_int8,
    )
    from unet_medical_image_contour_segmentation_torch.engine.predict import (
        ExportedPredictor,
    )

    model = seeded_model("yolov8_seg_s", MODEL_SEED)
    images = smooth_images(1, BATCH, HW)
    q = Predictor(model, device="cuda", compute_dtype=torch.bfloat16, quantize=True)
    bf16 = Predictor(model, device="cuda", compute_dtype=torch.bfloat16)
    reset_launches()
    q.predict_array(images)
    calib = int8_counts()
    want = {"conv3x3_int8": YOLO_INT8_PROTO, "conv3x3_nhwc": YOLO_BF16_PROTO}
    if calib != {"conv3x3_int8": YOLO_INT8_PROTO,
                 "conv3x3_nhwc": YOLO_PER_FORWARD + YOLO_BF16_PROTO}:
        raise RuntimeError(f"[C5] the calibrating first call launched {calib}")
    reset_launches()
    masks = q.predict_array(images)
    launches = int8_counts()
    if launches != want:
        raise RuntimeError(f"[C5] a proto int8 forward launched {launches}, want {want}")
    if masks.shape != (BATCH, HW, HW) or not set(np.unique(masks)) <= {0, 1}:
        raise RuntimeError(f"[C5] masks {masks.shape} with values {np.unique(masks)}")
    with exact_f32():
        ref = Predictor(model, device="cuda").predict_array(images)
    agree = float((masks == ref).mean())
    agree_bf16 = float((bf16.predict_array(images) == ref).mean())
    cut = images[:2, :PP_INT8_CPU_HW, :PP_INT8_CPU_HW]
    card_vs_cpu = int8_card_vs_cpu(model, q._amax, cut)
    if card_vs_cpu < MIN_YOLO_CARD_VS_CPU:
        raise RuntimeError(f"[C5] the card's int8 masks agree with the CPU's on "
                           f"{card_vs_cpu:.4%} < {MIN_YOLO_CARD_VS_CPU:.2%}")

    full = build_qparams_yolo(q._qfolded, q._amax, scope="full", device="cuda")
    x = torch.from_numpy(images).cuda()
    reset_launches()
    with torch.inference_mode():
        full_masks = q._classes(apply_int8(full, x, torch.bfloat16)).cpu().numpy()
    full_launches = int8_counts()
    if full_launches != {"conv3x3_int8": YOLO_INT8_FULL, "conv3x3_nhwc": 0}:
        raise RuntimeError(f"[C5] a full-scope int8 forward launched {full_launches}, want "
                           f"{YOLO_INT8_FULL} int8 and no bf16 kernel launch")
    full_agree = float((full_masks == ref).mean())
    if not 0.0 < full_masks.mean() < 1.0:
        raise RuntimeError(f"[C5] full-scope masks are all {full_masks.flat[0]}")
    # one forward queued at a time (C4), in turns; "folded" is the int8
    # walker on the f32 CBS fold with no int8 entry: the BN-folded bf16
    # forward, which the proto scope's backbone and neck run
    with torch.inference_mode():
        fwd = {"bf16": lambda i: bf16._classes(bf16.model(x)),
               "folded": lambda i: q._classes(apply_int8(q._qfolded, x, torch.bfloat16)),
               "proto": lambda i: q._classes(apply_int8(q._qparams, x, torch.bfloat16)),
               "full": lambda i: q._classes(apply_int8(full, x, torch.bfloat16))}
        dev = {k: [] for k in fwd}
        for k in ("bf16", "folded", "proto", "full", "full", "proto", "folded", "bf16"):
            dev[k].append(time_ms(fwd[k], reps=1, warmup=2)[0])
    route_ms, route_calls, route_bound_ms, route_bound_by = int_mm_route_ms(full, x)
    serve = serve_numbers(q, images, queued_reps=1)
    bf16_rate = host_rate(bf16, images, reps=10)[0]
    if profile_dir:
        for name, k in (("yolo_int8_predict", "proto"), ("yolo_int8_full", "full"),
                        ("yolo_folded_predict", "folded"), ("yolo_bf16_predict", "bf16")):
            profile_forward(lambda: fwd[k](0), Path(profile_dir), name)
    result = dict(agreement_f32=agree, bf16_agreement_f32=agree_bf16, card_vs_cpu=card_vs_cpu,
                  foreground=float(masks.mean()), full_agreement_f32=full_agree,
                  **{f"{k}_forward_ms": float(np.mean(v)) for k, v in dev.items()},
                  forward_ms_runs=dev, int_mm_route_ms=route_ms, int_mm_route_calls=route_calls,
                  int_mm_route_bound_ms=route_bound_ms, int_mm_route_bound_by=route_bound_by,
                  bf16_slices_per_s=bf16_rate, **serve)
    log(f"[C5 yolov8_seg_s int8] ({BATCH}, {HW}, {HW}) bf16 compute, proto scope: calibration "
        f"{calib}, then {launches} a forward; masks vs f32 {agree:.4%} (bf16 vs f32 "
        f"{agree_bf16:.4%}), foreground {result['foreground']:.3f}; card vs CPU int8 masks (f32 "
        f"compute, {tuple(cut.shape)}) {card_vs_cpu:.4%}; full scope: {full_launches} a "
        f"forward, masks vs f32 {full_agree:.4%}, its {route_calls} 1x1 / stride-2 convs on "
        f"torch._int_mm {route_ms:.4f} ms (bound {route_bound_ms:.4f} ms, {route_bound_by}); "
        f"device forward+classes (one call queued) bf16 "
        f"{dev['bf16']} ms, BN-folded bf16 {dev['folded']} ms, proto {dev['proto']} ms, full "
        f"{dev['full']} ms (proto / folded "
        f"{result['proto_forward_ms'] / result['folded_forward_ms']:.3f}, proto / bf16 "
        f"{result['proto_forward_ms'] / result['bf16_forward_ms']:.3f}, full / bf16 "
        f"{result['full_forward_ms'] / result['bf16_forward_ms']:.3f}); host slices/s int8 "
        f"{serve['slices_per_s']:.1f}, bf16 {bf16_rate:.1f}; int8 batch-1 p50 "
        f"{serve['latency_p50_ms']:.3f} ms; peak memory {serve['peak_mib']:.1f} MiB")

    t0 = time.perf_counter()
    data = export_program_int8(in_dtype(model, torch.bfloat16).eval(), q._qparams,
                               example_hw=(HW, HW))
    export_s = time.perf_counter() - t0
    exported = ExportedPredictor(data, device="cuda")
    exported.predict_array(images[:1])  # warm-up
    reset_launches()
    e_masks = exported.predict_array(images)
    e_launches = int8_counts()
    e_agree = float((e_masks == q.predict_array(images)).mean())
    if e_launches != want or e_agree != 1.0:
        raise RuntimeError(f"[C5 export int8] a program forward launched {e_launches}; masks "
                           f"equal to the live int8 Predictor's on {e_agree:.6%}")
    result["export"] = dict(bytes=len(data), export_s=export_s, agreement=e_agree,
                            slices_per_s=host_rate(exported, images, reps=10)[0])
    log(f"[C5 yolov8_seg_s int8 export] program at {HW}² ({len(data)} bytes, export "
        f"{export_s:.1f} s): {e_launches} a forward; masks equal to the live int8 "
        f"Predictor's on {e_agree:.4%}; host {result['export']['slices_per_s']:.1f} slices/s")
    return ({"yolo_int8_predict": launches, "yolo_int8_full": full_launches,
             "yolo_int8_export": e_launches}, result)


# D1-D3: data parallelism on the one card.  D2 splits (BATCH, HW, HW) over
# two ranks of RANK_BATCH rows, D3 each served batch over two replicas
DP_RANKS = 2
RANK_BATCH = BATCH // DP_RANKS
DP_TIMEOUT_S = 300
# D1 (bf16 compute): the data-parallel step at world size 1 against the
# plain step from the same weights, bit for bit: both take the BN variance
# one-pass (JAX's formula; A0), the collectives of one rank are identities,
# and cuDNN is held to its deterministic algorithms for the two steps.
# D2 (f32, TF32 off): two ranks of RANK_BATCH rows against one process's
# (BATCH, HW, HW) step, the statistics summed in another order (on the CPU
# at 64x64 the gradients agree to 3e-6 of the largest; the gradients are
# held to phase 6's 1e-3 of the largest)
D2_TOL = dict(loss=1e-5, grads=1e-3, grad_norm=1e-4, buf_rtol=1e-4, buf_atol=1e-5)


def bn_inputs(model, image: torch.Tensor) -> list:
    """(x, scale, bias) of every train-mode BN of one forward of ``model``,
    in the order the forward normalises them."""
    captured, batch_norm = [], blocks_module.batch_norm

    def capture(x, scale, bias, running_mean, running_var, **kw):
        captured.append((x.detach(), scale.detach(), bias.detach()))
        return batch_norm(x, scale, bias, running_mean, running_var, **kw)

    blocks_module.batch_norm = capture
    try:
        with torch.no_grad():
            model.train()(image)
    finally:
        blocks_module.batch_norm = batch_norm
    return captured


def bn_formula_errors(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> dict:
    """One BN's output under each variance formula, computed in f32 as
    ``ops/nn.py:batch_norm`` computes it, against the same BN in f64: the
    largest error of the f32 output, of the output rounded to x's dtype (what
    the step goes on with), and of the variance (relative)."""
    x64 = x.double()
    var64, mean64 = torch.var_mean(x64, dim=(0, 1, 2), unbiased=False)
    y64 = (x64 - mean64) * torch.rsqrt(var64 + BN_EPS) * scale.double() + bias.double()
    xf = x.float()
    mean = xf.mean(dim=(0, 1, 2))
    formulas = {"two_pass": torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)[::-1],
                "one_pass": (mean, xf.square().mean(dim=(0, 1, 2)) - mean.square())}
    out = {"mean_over_std": (mean64.abs() / var64.sqrt()).max().item(),
           "y_max": y64.abs().max().item()}
    for name, (m, var) in formulas.items():
        y = (xf - m) * (torch.rsqrt(var + BN_EPS) * scale.float()) + bias.float()
        out[name] = dict(f32=(y.double() - y64).abs().max().item(),
                         rounded=(y.to(x.dtype).double() - y64).abs().max().item(),
                         var_rel=((var.double() - var64).abs() / var64).max().item())
    return out


def phase_bn_formula() -> dict:
    """A0: the two BN variance formulas against an f64 BN on D1's
    activations (the seeded unet_s's train forward at (BATCH, HW, HW), bf16
    compute): for each of its 18 BNs, the largest error of each formula's
    output (f32, and rounded to bf16 as the step goes on with it) and of its
    variance.  The one-pass formula (JAX's ``mean_sq - mean**2``) is "no
    worse in bf16" where, at every BN, its bf16 output's error exceeds the
    two-pass formula's by less than one bf16 rounding step of the output's
    largest magnitude (2**-8 of it).  -> the numbers and the verdict."""
    model = seeded_unet_s(torch.bfloat16).cuda()
    rows = [bn_formula_errors(*t) for t in bn_inputs(model, device_batch(6)["image"])]
    del model
    no_worse = all(r["one_pass"]["rounded"] <= r["two_pass"]["rounded"] + r["y_max"] * 2 ** -8
                   for r in rows)
    for i, r in enumerate(rows):
        one, two = r["one_pass"], r["two_pass"]
        log(f"[A0 bn formula] BN {i:2d}: |mean|/std {r['mean_over_std']:.3g}, max |y| "
            f"{r['y_max']:.3g}; one-pass f32 {one['f32']:.3g} bf16 {one['rounded']:.3g} var rel "
            f"{one['var_rel']:.3g}; two-pass f32 {two['f32']:.3g} bf16 {two['rounded']:.3g} var "
            f"rel {two['var_rel']:.3g}")
    worst = {k: {e: max(r[k][e] for r in rows) for e in ("f32", "rounded", "var_rel")}
             for k in ("one_pass", "two_pass")}
    log(f"[A0 bn formula] unet_s bf16 ({BATCH}, {HW}, {HW}), {len(rows)} BNs, largest errors "
        f"against f64: {worst}; one-pass no worse in bf16: {no_worse}")
    return dict(bns=len(rows), worst=worst, one_pass_no_worse=no_worse, per_bn=rows)


def step_diffs(a: tuple, b: tuple) -> dict:
    """The differences of two one_train_step-style results (metrics, grads,
    params, buffers on the host)."""
    (ma, ga, pa, ba), (mb, gb, pb, bb) = a, b
    g_max = max(g.abs().max().item() for g in gb.values())
    return dict(
        loss=abs(ma["loss"] - mb["loss"]) / abs(mb["loss"]),
        grad_norm=abs(ma["grad_norm"] - mb["grad_norm"]) / mb["grad_norm"],
        grads=max((ga[n] - gb[n]).abs().max().item() for n in gb) / g_max,
        params=max((pa[n] - pb[n]).abs().max().item() for n in pb),
        buffers=max((ba[n].float() - bb[n].float()).abs().max().item() for n in bb),
        g_max=g_max)


def check_step_diffs(label: str, d: dict, tol: dict, a_buffers: dict, b_buffers: dict) -> None:
    bufs_ok = all(torch.allclose(a_buffers[n].float(), b_buffers[n].float(), rtol=tol["buf_rtol"],
                                 atol=tol["buf_atol"]) for n in b_buffers)
    if (d["loss"] > tol["loss"] or d["grad_norm"] > tol["grad_norm"] or d["grads"] > tol["grads"]
            or d["params"] > 20 * TRAIN_LR + 1e-6 or not bufs_ok):
        raise RuntimeError(f"[{label}] the parallel step differs from the plain one: {d} "
                           f"(bounds {tol}, params 20 * lr), BN buffers within bounds {bufs_ok}")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms (its weight gradients may
    otherwise sum with atomics, in another order on every call)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def bit_equal(a: tuple, b: tuple) -> bool:
    """Two host_step results are equal bit for bit."""
    (ma, *ta), (mb, *tb) = a, b
    return ma == mb and all(x.keys() == y.keys() and all(torch.equal(x[n], y[n]) for n in x)
                            for x, y in zip(ta, tb))


def host_step(model, metrics) -> tuple:
    """A step's (metrics, grads, params, buffers) on the host."""
    def host(named):
        return {n: t.detach().float().cpu() for n, t in named}

    return ({k: v.item() for k, v in metrics.items() if v.dim() == 0},
            host((n, p.grad) for n, p in model.named_parameters()),
            host(model.named_parameters()), host(model.named_buffers()))


def timed_steps(step, batch, n: int = TRAIN_STEPS) -> tuple:
    """(ms per step, peak MiB) of ``n`` steps on a resident batch after
    TRAIN_WARMUP warm-ups, CUDA events."""
    for _ in range(TRAIN_WARMUP):
        step(batch, TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step(batch, TRAIN_LR)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, torch.cuda.max_memory_allocated() / 2**20


def collective_cost(step, batch) -> dict:
    """Where D1's extra step time goes: the all-reduces of one data-parallel
    step (counted by wrapping ``dist.all_reduce``), and one lone all-reduce
    of a BN layer's (2, 16) statistics: host issue µs and device ms (CUDA
    events, 50 calls as a caller issues them)."""
    calls, all_reduce = [], dist.all_reduce

    def counted(t, *args, **kw):
        calls.append(t.numel())
        return all_reduce(t, *args, **kw)

    dist.all_reduce = counted
    try:
        step(batch, TRAIN_LR)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    t = torch.zeros(2, 16, device="cuda")
    device_ms, host_ms = time_ms(lambda i: dist.all_reduce(t), reps=50, queued=False)
    return dict(per_step=len(calls), elements=sum(calls), host_us=host_ms * 1e3,
                device_ms=device_ms)


def phase_dp_world1(profile_dir=None):
    """D1: make_parallel_train_step at world size 1 (NCCL, one process) on
    the seeded unet_s at (BATCH, HW, HW), bf16 compute / f32 master, against
    the plain step from the same weights, bit for bit; 7 + 7 kernel launches a
    step on the tensor cores; step ms as a caller sees it (CUDA events,
    steps issued one after another) and peak memory of both, in turns
    (plain, dp, dp, plain); the all-reduces a step and one's cost; with
    ``profile_dir``, both steps' profiler tables (their device time).
    (Queued behind a sleep, the data-parallel steps are not the device
    alone: the host then waits in them, see PERF.md.)  -> (launches,
    numbers)."""
    per_step = len(MAIN_CONVS)
    want = {"conv3x3_nhwc": per_step, "conv3x3_nhwc.tensor_core": per_step,
            "conv3x3_nhwc_dx": per_step, "conv3x3_nhwc_dx.tensor_core": per_step,
            "bias_relu_nhwc": 0}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            group = make_data_group()
            batch = device_batch(6)
            models = {k: seeded_unet_s(torch.bfloat16).cuda() for k in ("plain", "dp")}
            opt = RMSpropConfig(learning_rate=TRAIN_LR)
            steps = {"plain": make_train_step(models["plain"], LossConfig(), opt),
                     "dp": make_parallel_train_step(models["dp"], LossConfig(), opt, group)}
            replicate(models["dp"], steps["dp"].optimizer, group)
            with deterministic_cudnn():
                reset_launches()
                got = host_step(models["dp"], steps["dp"](batch, TRAIN_LR))
                first = read_launches()
                ref = host_step(models["plain"], steps["plain"](batch, TRAIN_LR))
            if first != want:
                raise RuntimeError(f"[D1] one data-parallel step launched {first}, want {want}")
            diffs = step_diffs(got, ref)
            if not bit_equal(got, ref):
                raise RuntimeError(f"[D1] the data-parallel step at world size 1 is not the plain "
                                   f"step bit for bit: {diffs}")
            collectives = collective_cost(steps["dp"], batch)
            runs = {"plain": [], "dp": []}
            timed = {k: 0 for k in want}
            for k in ("plain", "dp", "dp", "plain"):
                if k == "dp":
                    reset_launches()
                runs[k].append(timed_steps(steps[k], batch))
                if k == "dp":
                    timed = {n: timed[n] + v for n, v in read_launches().items()}
            n_dp = 2 * (TRAIN_WARMUP + TRAIN_STEPS)
            if timed != {n: v * n_dp for n, v in want.items()}:
                raise RuntimeError(f"[D1] {n_dp} data-parallel steps launched {timed}, want "
                                   f"{want} a step")
            if profile_dir:
                for k in ("plain", "dp"):
                    profile_train(steps[k], batch, Path(profile_dir), f"train_{k}_world1",
                                  by_cpu=True)
        finally:
            dist.destroy_process_group()
    ms = {k: float(np.mean([r[0] for r in v])) for k, v in runs.items()}
    peak = {k: max(r[1] for r in v) for k, v in runs.items()}
    log(f"[D1 dp world 1] unet_s bf16 ({BATCH}, {HW}, {HW}), NCCL, one rank: {per_step} + "
        f"{per_step} launches a step; vs the plain step from the same weights: loss rel "
        f"{diffs['loss']:.3g}, grad norm rel {diffs['grad_norm']:.3g}, grads "
        f"{diffs['grads']:.3g} of the largest ({diffs['g_max']:.3g}), params max "
        f"{diffs['params']:.3g}, BN buffers max {diffs['buffers']:.3g} (bit-equal); step "
        f"{ms['dp']:.3f} ms (dp) vs {ms['plain']:.3f} ms (plain), ratio "
        f"{ms['dp'] / ms['plain']:.4f} (runs {runs}), peak {peak['dp']:.1f} vs "
        f"{peak['plain']:.1f} MiB; {collectives['per_step']} all-reduces a step "
        f"({collectives['elements']} elements), a lone one {collectives['host_us']:.1f} us of "
        f"host issue and {collectives['device_ms']:.4f} ms on the device: "
        f"{collectives['per_step'] * collectives['host_us'] / 1e3:.2f} ms of host time a step")
    launches = {n: first[n] + timed[n] for n in want}
    return launches, dict(step_ms=ms["dp"], plain_step_ms=ms["plain"],
                          ratio=ms["dp"] / ms["plain"], runs=runs, peak_mib=peak["dp"],
                          plain_peak_mib=peak["plain"], diffs=diffs,
                          collectives=collectives)


def d2_rank(rank: int, rendezvous: str, backend: str, data: dict, out: str) -> None:
    """One rank of D2 on cuda:0: for each criterion, the seeded f32 unet_s
    takes one data-parallel step (TF32 off) on its RANK_BATCH rows of
    ``data``; its results, launch counts and launched shapes go to ``out``.
    With ``backend`` "nccl-probe" it only tries one NCCL all-reduce."""
    torch.cuda.set_device(0)
    record_launches()
    if backend == "nccl-probe":
        dist.init_process_group("nccl", init_method=rendezvous, world_size=DP_RANKS, rank=rank)
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        torch.save({"sum": t.item()}, f"{out}.{rank}")
        dist.destroy_process_group()
        return
    dist.init_process_group(backend, init_method=rendezvous, world_size=DP_RANKS, rank=rank)
    group = make_data_group()
    rows = slice(rank * RANK_BATCH, (rank + 1) * RANK_BATCH)
    result = {}
    for n_classes in (3, 1):
        model = seeded_unet_s(n_classes=n_classes).cuda()
        step = make_parallel_train_step(model, LossConfig(n_classes=n_classes),
                                        RMSpropConfig(learning_rate=TRAIN_LR), group)
        replicate(model, step.optimizer, group)
        batch = {k: torch.from_numpy(v[rows]).cuda() for k, v in data.items()}
        with exact_f32():
            reset_launches()
            metrics = step(batch, TRAIN_LR)
            torch.cuda.synchronize()
            launches = read_launches()
        result[n_classes] = (host_step(model, metrics), launches)
    result["launched"] = sorted(LAUNCHED)
    torch.save(result, f"{out}.{rank}")
    dist.destroy_process_group()


def spawn_ranks(target, n: int, args: tuple, out: str, timeout: float = DP_TIMEOUT_S) -> tuple:
    """``target(rank, rendezvous, *args, out)`` in ``n`` spawned processes on
    cuda:0 (a ``file://`` rendezvous beside ``out``) -> (exit codes, results
    of the ranks that wrote them to ``out.<rank>``); a rank still running
    after ``timeout`` seconds is killed."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, f"file://{out}.rendezvous", *args, out))
             for r in range(n)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(timeout)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    results = [torch.load(f"{out}.{r}", weights_only=False) if os.path.exists(f"{out}.{r}")
               else None for r in range(n)]
    return [proc.exitcode for proc in procs], results


def phase_dp_two_ranks():
    """D2: two ranks on the one card, each a process with RANK_BATCH of the
    (BATCH, HW, HW) rows on cuda:0, over gloo (NCCL first, to record whether
    it takes two ranks on one device): one f32 step (TF32 off) of the
    multiclass and of the binary criterion against the single process's
    (BATCH, HW, HW) step on the card (D2_TOL); each rank's launches, 7 + 7
    a step (f32: the CUDA-core kernel).  -> (launches by rank, numbers)."""
    data = rect_batch(8, BATCH, HW, HW)
    with tempfile.TemporaryDirectory() as tmp:
        codes, probe = spawn_ranks(d2_rank, DP_RANKS, ("nccl-probe", {}),
                                   os.path.join(tmp, "nccl-probe"), timeout=90)
        nccl = ("two ranks on one device ran an all-reduce (sum "
                f"{probe[0]['sum']})" if all(c == 0 for c in codes)
                else f"refused (rank exit codes {codes})")
        log(f"[D2 dp two ranks] NCCL with two ranks on cuda:0: {nccl}; D2 runs over gloo")
        codes, ranks = spawn_ranks(d2_rank, DP_RANKS, ("gloo", data), os.path.join(tmp, "gloo"))
    if any(c != 0 for c in codes) or any(r is None for r in ranks):
        raise RuntimeError(f"[D2] a gloo rank failed: exit codes {codes}")
    per_step = len(MAIN_CONVS)
    want = {"conv3x3_nhwc": per_step, "conv3x3_nhwc.tensor_core": 0,
            "conv3x3_nhwc_dx": per_step, "conv3x3_nhwc_dx.tensor_core": 0, "bias_relu_nhwc": 0}
    numbers, launches = {"nccl_two_ranks_one_device": nccl}, {}
    for n_classes, label in ((3, "multiclass"), (1, "binary")):
        (got, got_launches), (other, other_launches) = ranks[0][n_classes], ranks[1][n_classes]
        if got_launches != want or other_launches != want:
            raise RuntimeError(f"[D2 {label}] the ranks launched {got_launches} and "
                               f"{other_launches}, want {want}")
        same = all(torch.equal(got[2][n], other[2][n]) for n in got[2])
        ref = one_train_step("cuda", data, n_classes)
        diffs = step_diffs(got, ref)
        if not same:
            raise RuntimeError(f"[D2 {label}] the two ranks' parameters differ after the step")
        check_step_diffs(f"D2 {label}", diffs, D2_TOL, got[3], ref[3])
        for r in range(DP_RANKS):
            launches[f"train_dp_rank{r}_{label}"] = ranks[r][n_classes][1]
        numbers[label] = dict(diffs, loss_value=got[0]["loss"], grad_norm_value=got[0]["grad_norm"])
        log(f"[D2 dp two ranks] {label} unet_s f32 step, 2 ranks x ({RANK_BATCH}, {HW}, {HW}) "
            f"on cuda:0 over gloo vs one process at ({BATCH}, {HW}, {HW}): loss "
            f"{got[0]['loss']:.6f} (rel {diffs['loss']:.3g}), global grad norm "
            f"{got[0]['grad_norm']:.6f} (rel {diffs['grad_norm']:.3g}), grads max diff "
            f"{diffs['grads']:.3g} of the largest ({diffs['g_max']:.3g}), params max "
            f"{diffs['params']:.3g}, BN buffers max {diffs['buffers']:.3g}; ranks bit-equal; "
            f"launches a rank {got_launches}")
    for r in ranks:
        LAUNCHED.update(r["launched"])
    return launches, numbers


def phase_dp_serve(model):
    """D3: Predictor(devices=["cuda:0", "cuda:0"]) on unet_s bf16 against the
    single-device Predictor: a ragged dense batch of 7 at HW² (padded to 8,
    4 rows a replica), one 2048² scan tiled (auto tile 512: two groups of 8
    windows, one a replica), and int8 at (BATCH, HW, HW), each calibrating
    on its first 4 images; masks 100% equal; launches; host slices/s of
    both at (BATCH, HW, HW), in turns.  -> (launches by path, numbers)."""
    bf16 = dict(compute_dtype=torch.bfloat16, tile_halo=HALO)
    one = Predictor(model, device="cuda", **bf16)
    two = Predictor(model, devices=["cuda:0", "cuda:0"], **bf16)
    q_one = Predictor(model, device="cuda", quantize=True, **bf16)
    q_two = Predictor(model, devices=["cuda:0", "cuda:0"], quantize=True, **bf16)
    ragged = smooth_images(31, BATCH - 1, HW)
    scan = smooth_images(32, 1, 2048, cells=64)
    images = smooth_images(33, BATCH, HW)
    cases = [("dense", one, two, ragged), ("tiled", one, two, scan),
             ("int8", q_one, q_two, images)]
    for _, a, b, x in cases:  # warm-up: cuDNN picks its algorithms per shape
        a.predict_array(x)
        b.predict_array(x)
    torch.cuda.synchronize()
    per_forward = len(MAIN_CONVS)
    tiled_forwards = group_forwards(two, *scan.shape)
    want = {"dense": fwd_launches(DP_RANKS * per_forward, DP_RANKS * UNET_PASSES),
            "tiled": fwd_launches(tiled_forwards * per_forward, tiled_forwards * UNET_PASSES),
            "int8": {"conv3x3_int8": DP_RANKS * len(INT8_CONVS), "conv3x3_nhwc": 0}}
    launches, numbers = {}, {}
    for name, a, b, x in cases:
        reset_launches()
        got = b.predict_array(x)
        launches[name] = int8_counts() if name == "int8" else read_launches()
        if launches[name] != want[name]:
            raise RuntimeError(f"[D3 {name}] data-parallel predict_array{x.shape} launched "
                               f"{launches[name]}, want {want[name]}")
        ref = a.predict_array(x)
        check_masks(got, x.shape[:3])
        agree = float((got == ref).mean())
        numbers[f"{name}_agreement"] = agree
        log(f"[D3 dp serve] {name} {tuple(x.shape)}: 2 replicas on cuda:0 vs one Predictor, "
            f"masks agree on {agree:.6%} of pixels ({int((got != ref).sum())} differ); "
            f"launches {launches[name]}")
        if agree < 1.0:
            raise RuntimeError(f"[D3 {name}] data-parallel masks differ from single-device "
                               f"serving on {int((got != ref).sum())} pixels")
    if q_one._amax != q_two._amax:
        raise RuntimeError("[D3 int8] the two Predictors calibrated apart")
    rates = {"one": [], "two": []}
    for k, pred in (("one", one), ("two", two), ("two", two), ("one", one)):
        rates[k].append(host_rate(pred, images, reps=10)[0])
    numbers.update(slices_per_s=float(np.mean(rates["two"])),
                   single_slices_per_s=float(np.mean(rates["one"])), rate_runs=rates)
    log(f"[D3 dp serve] host slices/s at ({BATCH}, {HW}, {HW}): 2 replicas on cuda:0 "
        f"{numbers['slices_per_s']:.1f}, one Predictor {numbers['single_slices_per_s']:.1f} "
        f"(runs {rates})")
    return launches, numbers


# S1-S6: spatial parallelism (parallel/spatial.py), the ranks spawned on
# cuda:0 over gloo as D2's.  S1: unet_s (3 classes, ConvT ups) at S1_SHAPE,
# 512 rows a rank; S2: the variants at S2_SHAPE; S3: the 2 x 2 (data,
# spatial) layout at S3_SHAPE; S4: one S4_HW² scan through the spatial eval
# forward; S5: yolov8_seg_s's binary step at S5_SHAPE (S1's large scans);
# S6: the served yolov8_seg_s's forward of one S6_HW² scan.
SP_RANKS = 2
S1_SHAPE = (2, 1024, 1024)
S2_SHAPE = (2, HW, HW)
S3_SHAPE, S3_DP = (4, HW, HW), 2
S4_HW = 2048
S5_SHAPE, S6_HW = S1_SHAPE, S4_HW
S_VARIANTS = ("bilinear", "unet_sa", "binary", "remat", "unet_pp_s")
S_TIMED_STEPS = 5
# S1 and S3 (f32, TF32 off) against one process's plain step on the whole
# batch: the bounds D2 meets on the card (loss rel 1.9e-6, gradients 6.4e-5
# of the largest, PERF.md): loss 2e-6 relative, gradients 1e-4 of the
# largest, grad norm 1e-4, BN buffers rtol 1e-4 / atol 1e-5, parameters
# 20 * lr.
S_TOL = dict(loss=2e-6, grads=1e-4, grad_norm=1e-4, buf_rtol=1e-4, buf_atol=1e-5)
# S2's variants and S5: D2's gate.  A band's convs that cuDNN runs (Cin = 1
# or > 32, unet_sa's 7x7 gate; YOLO's stem, stride-2 and 1x1 convs) take
# other algorithms at the band's shape than at the whole image's, so their
# sums round apart, and a ReLU input within that of zero takes the other
# side (in YOLO, a max-pool near-tie the other window member): in this
# script's runs on the card unet_sa's gradients came 2.1e-4 and binary's
# 1.1e-4 of the largest from the plain step's, where unet_s's came 6.0e-5
# (PERF.md)
S2_TOL = D2_TOL


# the UNet variants of S_VARIANTS: their factory's keywords
S_UNET_KW = {"bilinear": dict(bilinear=True), "unet_sa": dict(factory=unet_sa),
             "binary": dict(n_classes=1), "remat": dict(remat=True)}


def s_model(name: str, compute_dtype=None):
    """The seeded model of a spatial case on the card: unet_s, a variant of
    S_VARIANTS, yolov8_seg_s (C4's train model), or in eval mode
    (``served``) phase 5's unet_s or (``served_yolo``) C4's served
    yolov8_seg_s (live BN)."""
    if name == "served":
        model = build_model(seed=MODEL_SEED).eval()
        model.compute_dtype = compute_dtype
    elif name == "served_yolo":
        model = seeded_model("yolov8_seg_s", MODEL_SEED)
        model.compute_dtype = compute_dtype
    elif name == "yolov8_seg_s":
        model = seeded_model(name, MODEL_SEED, centre=False, compute_dtype=compute_dtype)
    elif name == "unet_pp_s":
        model = seeded_model("unet_pp_s", MODEL_SEED, centre=False, n_classes=3,
                             compute_dtype=compute_dtype)
    else:
        model = seeded_unet_s(compute_dtype, **S_UNET_KW.get(name, {}))
    return model.cuda()


def s_loss(name: str) -> LossConfig:
    return LossConfig(n_classes=1 if name in ("binary", "yolov8_seg_s") else 3)


def s_want(name: str, dtype) -> dict:
    """The read_launches() of one step (or, for a served model, one forward)
    of a spatial case on a rank: the plain step's counts."""
    n = len(routed_convs(s_model_cpu(name)))
    fwd, dx = (n, 0) if name.startswith("served") else (2 * n if name == "remat" else n, n)
    tc = dtype == torch.bfloat16
    return {"conv3x3_nhwc": fwd, "conv3x3_nhwc.tensor_core": fwd if tc else 0,
            "conv3x3_nhwc_dx": dx, "conv3x3_nhwc_dx.tensor_core": dx if tc else 0,
            "bias_relu_nhwc": 0}  # S4 serves the live-BN eval model: nothing folded


def s_shapes() -> list:
    """(label, B, h, W, Cin, Cout, path) of the 3x3 convs that a rank of
    S1-S6 launches the kernel at: its band's rows plus the two halo rows, at
    every level, for every conv the dispatch rule routes (the dx launches
    the same shapes, Cout -> Cin).  S1's (path "spatial") and S5's
    ("spatial_yolo") are timed (bf16); the others' path is None."""
    rows = []
    yolo = get_model("yolov8_seg_s")
    cases = [("S1", S1_SHAPE, 1, unet_s(), "spatial"), ("S3", S3_SHAPE, S3_DP, unet_s(), None),
             ("S4", (1, S4_HW, S4_HW), 1, unet_s(), None),
             ("S5", S5_SHAPE, 1, yolo, "spatial_yolo"), ("S6", (1, S6_HW, S6_HW), 1, yolo, None)]
    cases += [(f"S2 {name}", S2_SHAPE, 1, s_model_cpu(name), None) for name in S_VARIANTS]
    for label, (b, h, w), dp, model, path in cases:
        sp = (SP_RANKS * S3_DP if label == "S3" else SP_RANKS) // dp
        for name, cin, cout, s in routed_convs(model):
            rows.append((f"{label} {name}", b // dp, h // (sp * s) + 2, w // s, cin, cout, path))
    seen, out = set(), []
    for row in rows:  # every S1 and S5 conv (they are timed), other shapes once
        if row[6] or row[1:6] not in seen:
            seen.add(row[1:6])
            out.append(row)
    return out


def s_model_cpu(name: str):
    """A spatial case's architecture (no weights) for routed_convs."""
    if name in ("unet_pp_s", "yolov8_seg_s"):
        return get_model(name)
    if name == "served_yolo":
        return get_model("yolov8_seg_s")
    kw = dict(S_UNET_KW.get(name, {}))
    return kw.pop("factory", unet_s)(**kw)


def s_step_times(step, batch, n: int = S_TIMED_STEPS) -> dict:
    """Host ms per step (synchronised) over ``n`` steps after 2 warm-ups, and
    the device's CUDA time per step from torch.profiler over 2 steps (None
    where the profiler shows none)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(batch, TRAIN_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch, TRAIN_LR)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(batch, TRAIN_LR)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    return dict(step_ms=host_ms, device_ms=device_us / 2e3 if device_us > 0 else None)


def s_plain_step(name: str, data: dict, dtype=None, timed: bool = False) -> dict:
    """One process's plain step of a spatial case on the whole batch, f32
    under exact_f32 (bf16 as phase 7 runs it): host_step, peak MiB above what
    was allocated before the model was built, and with ``timed`` its times."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = s_model(name, dtype)
    step = make_train_step(model, s_loss(name), RMSpropConfig(learning_rate=TRAIN_LR))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    with exact_f32() if dtype is None else contextlib.nullcontext():
        metrics = step(batch, TRAIN_LR)
        torch.cuda.synchronize()
    out = dict(step=host_step(model, metrics),
               peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20)
    if timed:
        out.update(s_step_times(step, batch))
    return out


def s_rank_step(mesh, name: str, data: dict, dtype, timed: bool) -> dict:
    """s_plain_step's numbers for this rank's block, through the
    row-sharded step (its launches counted)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = s_model(name, dtype)
    step = make_spatial_train_step(model, s_loss(name), RMSpropConfig(learning_rate=TRAIN_LR),
                                   mesh)
    replicate(model, step.optimizer, mesh.group)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in shard_batch(data, mesh).items()}
    with exact_f32() if dtype is None else contextlib.nullcontext():
        reset_launches()
        metrics = step(batch, TRAIN_LR)
        torch.cuda.synchronize()
        launches = read_launches()
    out = dict(step=host_step(model, metrics), launches=launches,
               peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20)
    if timed:
        out.update(s_step_times(step, batch))
    return out


def classes_of(logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 classes of (B, H, W, C) logits on the host, by the
    eval rule (engine/evaluate.py:eval_forward): argmax, or sigmoid > 0.5
    for one class."""
    if logits.shape[-1] == 1:
        return (torch.sigmoid(logits[..., 0]) > 0.5).to(torch.uint8).cpu()
    return logits.argmax(-1).to(torch.uint8).cpu()


def s_rank_forward(mesh, name: str, image: np.ndarray, dtype) -> dict:
    """S4 / S6 on a rank: the served model's classes of the whole scan
    through make_spatial_forward (a one-class model's logits too), and this
    rank's launches."""
    forward = make_spatial_forward(s_model(name, dtype), mesh)
    x = torch.from_numpy(image).cuda()
    with exact_f32() if dtype is None else contextlib.nullcontext():
        reset_launches()
        logits = forward(x)
        torch.cuda.synchronize()
        launches = read_launches()
    return dict(classes=classes_of(logits), launches=launches,
                logits=logits[..., 0].cpu() if logits.shape[-1] == 1 else None)


def s_rank(rank: int, rendezvous: str, world: int, dp: int, tasks: list, out: str) -> None:
    """One rank of S1-S6 on cuda:0 over gloo: the (dp, world / dp) layout,
    then each task (label, "step" | "forward", model name, data, dtype,
    timed); its results, launches and launched shapes go to ``out``."""
    torch.cuda.set_device(0)
    record_launches()
    dist.init_process_group("gloo", init_method=rendezvous, world_size=world, rank=rank)
    mesh = make_dp_spatial_mesh(dp, world // dp)
    result = {}
    for label, kind, name, data, dtype, timed in tasks:
        t0 = time.perf_counter()
        result[label] = (s_rank_step(mesh, name, data, dtype, timed) if kind == "step"
                         else s_rank_forward(mesh, name, data, dtype))
        result[label]["seconds"] = time.perf_counter() - t0
    result["launched"] = sorted(LAUNCHED)
    torch.save(result, f"{out}.{rank}")
    dist.destroy_process_group()


def spawn_spatial(world: int, dp: int, tasks: list, tmp: str) -> list:
    """S1-S6's ranks on cuda:0 (spawn_ranks) -> their results, their launched
    shapes added to LAUNCHED; a rank that fails fails the run."""
    codes, ranks = spawn_ranks(s_rank, world, (world, dp, tasks),
                               os.path.join(tmp, f"spatial{world}"))
    if any(c != 0 for c in codes) or any(r is None for r in ranks):
        raise RuntimeError(f"[S] a spatial rank failed: exit codes {codes}")
    for r in ranks:
        LAUNCHED.update(r["launched"])
    return ranks


def s_check(label: str, ranks: list, plain: dict, want: dict, tol) -> dict:
    """A row-sharded step's ranks against the plain step: every rank's
    launches equal ``want``, the ranks' parameters bit-equal, and (with
    ``tol``) the numbers within it; -> the differences."""
    results = [r[label] for r in ranks]
    for i, r in enumerate(results):
        if r["launches"] != want:
            raise RuntimeError(f"[{label}] rank {i} launched {r['launches']}, want {want}")
    first = results[0]["step"]
    if not all(all(torch.equal(first[2][n], r["step"][2][n]) for n in first[2])
               for r in results[1:]):
        raise RuntimeError(f"[{label}] the ranks' parameters differ after the step")
    diffs = step_diffs(first, plain["step"])
    if tol is not None:
        check_step_diffs(label, diffs, tol, first[3], plain["step"][3])
    return diffs


def s_name(label: str) -> str:
    """The model of a spatial step's label ("S2 unet_sa f32" -> unet_sa)."""
    if label.startswith("S2"):
        return label.split()[1]
    return "yolov8_seg_s" if label.startswith("S5") else "unet_s"


def s_timing(label: str, ranks: list, plain: dict, numbers: dict, shape) -> None:
    """A bf16 spatial step's host ms and CUDA time a rank beside the plain
    step's, into ``numbers[label]``, and its log line."""
    got = [r[label] for r in ranks]
    n = numbers[label]
    n.update(step_ms=[r["step_ms"] for r in got], device_ms=[r["device_ms"] for r in got],
             plain_step_ms=plain[label]["step_ms"], plain_device_ms=plain[label]["device_ms"])
    log(f"[{label}] {s_name(label)} {shape} over {SP_RANKS} ranks on one card: step "
        f"{n['step_ms']} ms a rank on the host clock (the two ranks share the card), CUDA "
        f"time {n['device_ms']} ms a rank; plain step {n['plain_step_ms']:.3f} ms, CUDA time "
        f"{n['plain_device_ms']} ms; peak a rank / plain "
        f"{[round(p / plain[label]['peak_mib'], 3) for p in n['peak_mib']]}")


def s_forward_check(label: str, ranks: list, model, scan: np.ndarray, dtype, want: dict,
                    launches: dict) -> dict:
    """S4 / S6: every rank's launches equal ``want`` and its classes of the
    scan against one process's forward of ``model``; f32 must agree on
    every pixel, else the run fails with the differing pixels' dense
    logits (their top-2 margin for several classes).  -> the numbers."""
    got = [r[label] for r in ranks]
    for i, r in enumerate(got):
        if r["launches"] != want:
            raise RuntimeError(f"[{label}] rank {i} launched {r['launches']}, want {want}")
        launches[f"{label.replace(' ', '_')}_rank{i}"] = r["launches"]
    with torch.inference_mode(), (exact_f32() if dtype is None else contextlib.nullcontext()):
        logits = model(torch.from_numpy(scan).cuda()).cpu()
    dense = classes_of(logits)
    agree = [float((r["classes"] == dense).float().mean()) for r in got]
    out = dict(agreement=agree)
    one = logits.shape[-1] == 1
    margin = logits[..., 0].abs() if one else top2_margin(logits)
    out["min_dense_margin"] = float(margin.min())
    if one:  # the band logits against the dense ones, and the margin they leave
        out["max_logit_diff"] = [float((r["logits"] - logits[..., 0]).abs().max()) for r in got]
    log(f"[{label}] one {scan.shape[1]}² scan over {SP_RANKS} ranks (make_spatial_forward) vs "
        f"one process's forward: masks agree on {[f'{a:.6%}' for a in agree]} of pixels; "
        f"{want['conv3x3_nhwc']} launches a rank; smallest dense "
        f"{'|logit|' if one else 'top-2 margin'} {out['min_dense_margin']:.3g}"
        + (f", band logits within {out['max_logit_diff']} of the dense ones" if one else ""))
    if dtype is None and min(agree) < 1.0:
        differ = torch.stack([r["classes"] != dense for r in got]).any(0)
        values = (logits[differ] if not one else logits[..., 0][differ]).tolist()
        raise RuntimeError(f"[{label}] f32 spatial masks differ from the dense forward's on "
                           f"{int(differ.sum())} pixels {differ.nonzero().tolist()[:20]}; their "
                           f"dense logits {values[:20]}")
    return out


def phase_spatial() -> tuple:
    """S1-S6 (see the module docstring): two spawned ranks on cuda:0 run S1
    and S5 (f32 gate, then bf16 reported and timed), S2's variants and S4's
    and S6's scans in one spawn, four ranks S3 in a second; the plain steps
    and the dense forwards run here.  -> (launches by path, numbers)."""
    t0 = time.perf_counter()
    s1, s2, s3, s5 = (rect_batch(41, *S1_SHAPE), rect_batch(42, *S2_SHAPE),
                      rect_batch(43, *S3_SHAPE), rect_batch(46, *S5_SHAPE))
    scans = {"S4": ("served", smooth_images(44, 1, S4_HW, cells=64)),
             "S6": ("served_yolo", smooth_images(47, 1, S6_HW, cells=64))}
    bf16 = torch.bfloat16
    tasks = [("S1 f32", "step", "unet_s", s1, None, False),
             ("S1 bf16", "step", "unet_s", s1, bf16, True),
             *[(f"S2 {n}", "step", n, s2, None, False) for n in S_VARIANTS],
             ("S5 f32", "step", "yolov8_seg_s", s5, None, False),
             ("S5 bf16", "step", "yolov8_seg_s", s5, bf16, True),
             *[(f"{key} {dt}", "forward", name, scan, dtype, False)
               for key, (name, scan) in scans.items()
               for dt, dtype in (("f32", None), ("bf16", bf16))]]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_spatial(SP_RANKS, 1, tasks, tmp)
        t_two = time.perf_counter() - t0
        ranks4 = spawn_spatial(S3_DP * SP_RANKS, S3_DP, [("S3 f32", "step", "unet_s", s3,
                                                          None, False)], tmp)
    t_ranks = time.perf_counter() - t0
    numbers, launches = {}, {}
    plain = {"S1 f32": s_plain_step("unet_s", s1), "S1 bf16": s_plain_step("unet_s", s1, bf16,
                                                                            timed=True),
             "S3 f32": s_plain_step("unet_s", s3),
             **{f"S2 {n}": s_plain_step(n, s2) for n in S_VARIANTS},
             "S5 f32": s_plain_step("yolov8_seg_s", s5),
             "S5 bf16": s_plain_step("yolov8_seg_s", s5, bf16, timed=True)}
    for label in plain:
        rs = ranks4 if label == "S3 f32" else ranks
        name = s_name(label)
        dtype = bf16 if label.endswith("bf16") else None
        tol = None if dtype == bf16 else S2_TOL if label[:2] in ("S2", "S5") else S_TOL
        diffs = s_check(label, rs, plain[label], s_want(name, dtype), tol)
        per_rank = [r[label] for r in rs]
        numbers[label] = dict(diffs, loss_value=per_rank[0]["step"][0]["loss"],
                              peak_mib=[r["peak_mib"] for r in per_rank],
                              plain_peak_mib=plain[label]["peak_mib"],
                              rank_seconds=[r["seconds"] for r in per_rank])
        for i, r in enumerate(per_rank):
            launches[f"{label.replace(' ', '_')}_rank{i}"] = r["launches"]
        log(f"[{label}] {per_rank[0]['launches']} launches a rank (the plain step's), ranks "
            f"bit-equal; vs one process's plain step: loss rel {diffs['loss']:.3g}, grad norm "
            f"rel {diffs['grad_norm']:.3g}, grads {diffs['grads']:.3g} of the largest "
            f"({diffs['g_max']:.3g}), params max {diffs['params']:.3g}, BN buffers max "
            f"{diffs['buffers']:.3g}{'' if tol is None else f' (gate {tol})'}; peak MiB a "
            f"rank {[round(r['peak_mib'], 1) for r in per_rank]} vs plain "
            f"{plain[label]['peak_mib']:.1f}")
    s_timing("S1 bf16", ranks, plain, numbers, S1_SHAPE)
    s_timing("S5 bf16", ranks, plain, numbers, S5_SHAPE)
    for key, (name, scan) in scans.items():
        for dt, dtype in (("f32", None), ("bf16", bf16)):
            numbers[f"{key} {dt}"] = s_forward_check(f"{key} {dt}", ranks,
                                                     s_model(name, dtype), scan, dtype,
                                                     s_want(name, dtype), launches)
    numbers["seconds"] = dict(two_ranks=t_two, four_ranks=t_ranks - t_two,
                              total=time.perf_counter() - t0,
                              yolo_rank_seconds=[sum(r[k]["seconds"] for k in r
                                                     if k[:2] in ("S5", "S6")) for r in ranks])
    log(f"[S time] S1, S2, S4-S6 ranks {t_two:.1f} s (S5 and S6 "
        f"{numbers['seconds']['yolo_rank_seconds']} s a rank), S3 ranks "
        f"{t_ranks - t_two:.1f} s, all of S1-S6 {numbers['seconds']['total']:.1f} s")
    return launches, numbers


def phase_launched_shapes() -> tuple:
    """Every shape at which a counted window of a main path launched the
    conv3x3 kernel (forward or dx) was held against the plain version in
    phase 3 or 4; every shape at which one launched the int8 kernel was held
    against its plain version in phase 10, or is held here (equal outputs
    on seeded operands, ReLU or SiLU as launched); -> the numbers of such
    shapes (bf16 / f32 kernel, int8 kernel, int8 checked here)."""
    unchecked = sorted(LAUNCHED - CHECKED)
    if not LAUNCHED or unchecked:
        raise RuntimeError(f"the main paths launched conv3x3 at shapes that no phase held "
                           f"against the plain version: {unchecked} (launched: "
                           f"{sorted(LAUNCHED)})")
    log(f"[shapes] the main paths launched conv3x3 at {len(LAUNCHED)} (B, H, W, Cin, Cout, "
        f"dtype) shapes, each held against the plain version in phase 3 or 4: "
        f"{sorted(LAUNCHED)}")
    rest = sorted(LAUNCHED8 - CHECKED8)
    for i, (b, h, w, cin, cin2, cout, out, act) in enumerate(rest):
        out_dtype = getattr(torch, out.removeprefix("torch."))
        operands = silu_operands if act == "silu" else int8_operands
        x, wp, mul, badd = operands(300 + i, b, h, w, cin + cin2, cout, "cuda")
        x, x2 = (x[..., :cin].contiguous(), x[..., cin:].contiguous()) if cin2 else (x, None)
        inv_s = (torch.tensor(SILU_INV_S, device="cuda")
                 if act == "silu" and out_dtype == torch.int8 else None)
        int8_check(x, wp, mul, badd, out_dtype, x2, act, inv_s)
        CHECKED8.add(int8_key(x, x2, cout, out_dtype, act))
    if not LAUNCHED8 or LAUNCHED8 - CHECKED8:
        raise RuntimeError(f"int8 launch shapes left unchecked: {sorted(LAUNCHED8 - CHECKED8)}")
    log(f"[shapes] the main paths launched conv3x3_int8 at {len(LAUNCHED8)} (B, H, W, Cin, "
        f"Cin2, Cout, out, act) shapes, each equal to its plain version: "
        f"{len(LAUNCHED8) - len(rest)} in phase 10, {len(rest)} checked here {rest}")
    return len(LAUNCHED), len(LAUNCHED8), len(rest)


def phase_bias_relu_shapes() -> tuple:
    """Every (B, H, W, C, dtype) at which a counted window launched the
    one-pass bias + ReLU is held bit for bit against torch.relu(y + b):
    phase 3 held unet_s's served forward at (BATCH, HW, HW), the rest (the
    tiled windows, the replicas' and the pipeline's batches, UNet++, the
    full models, f32) are held here; -> the numbers of such shapes and of
    those checked here."""
    rest = sorted(BR_LAUNCHED - BR_CHECKED)
    for i, (*shape, dtype) in enumerate(rest):
        bias_relu_check(tuple(shape), getattr(torch, dtype.removeprefix("torch.")), 400 + i)
    if not BR_LAUNCHED or BR_LAUNCHED - BR_CHECKED:
        raise RuntimeError(f"bias_relu_nhwc launch shapes left unchecked: "
                           f"{sorted(BR_LAUNCHED - BR_CHECKED)}")
    log(f"[shapes] the main paths launched bias_relu_nhwc at {len(BR_LAUNCHED)} (B, H, W, C, "
        f"dtype) shapes, each bit for bit torch.relu(y + b): {len(BR_LAUNCHED) - len(rest)} in "
        f"phase 3, {len(rest)} checked here {rest}")
    return len(BR_LAUNCHED), len(rest)


def shape_row(r) -> dict:
    return {k: r[k] for k in ("name", "path", "shape", "ms", "bound_ms", "library_ms",
                              "roofline")}


def shape_rows(rows) -> list:
    """The per-shape numbers of the ``kernels`` line."""
    return [shape_row(r) for r in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write torch.profiler tables of the bf16 and int8 forwards, the "
                         "train step and the data-parallel step at world size 1 to DIR")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    smi = phase_device()
    usage, build_dirs = phase_build()
    record_launches()
    rows, max_err = phase_kernels(usage)
    bias_relu_rows = phase_bias_relu()
    bwd_rows, bwd_err = phase_backward(usage)
    model = build_model(seed=MODEL_SEED)
    phase_small_reference(model)
    launches, main = phase_main_path(model, args.profile)
    phase_train_reference()
    train_launches, train, trained = phase_train(args.profile)
    train_model_launches, train["train_model"] = phase_train_model()
    train["save"] = phase_checkpoint_save()
    train["save"]["train_model"] = phase_train_model_saves()
    train["prefetch"] = phase_prefetch()
    phase_train_reference(n_classes=1)
    binary_launches, train["binary"] = phase_train_binary(train)
    variant_launches, train["variants"] = phase_train_variants()
    remat_launches, train["remat"] = phase_remat(args.profile)
    train["cc"] = phase_train_model_cc()
    tiled_launches, tiled = phase_tiled(model)
    pipeline_launches, pipeline = phase_pipeline()
    int8_rows, int8_err = phase_int8_kernels(usage)
    int8_launches, int8_main = phase_int8_main(model, trained, args.profile)
    int8_main["sweep"] = phase_int8_sweep()
    int8_tiled_launches, int8_main["tiled"] = phase_int8_tiled(model)
    int8_pipe_launches, int8_main["pipeline"] = phase_int8_pipeline()
    export_launches, export = phase_export(model)
    export8_launches, export["int8"] = phase_export_int8(model)
    pp_model, pp_launches, families = phase_pp_serve()
    pp = {"unet_pp_s": families}
    pp8_launches, pp["unet_pp_s"]["int8"] = phase_pp_int8(pp_model)
    pp_train_launches, pp["unet_pp_s"]["train"] = phase_pp_train()
    yolo_launches, pp["yolov8_seg_s"] = phase_yolo()
    yolo8_launches, pp["yolov8_seg_s"]["int8"] = phase_yolo_int8(args.profile)
    dp = {}
    dp1_launches, dp["world1"] = phase_dp_world1(args.profile)
    dp2_launches, dp["two_ranks"] = phase_dp_two_ranks()
    dp3_launches, dp["serve"] = phase_dp_serve(model)
    t0 = time.perf_counter()
    spatial = {"A0": phase_bn_formula()}
    spatial["A0"]["seconds"] = time.perf_counter() - t0
    log(f"[A0 time] {spatial['A0']['seconds']:.1f} s")
    sp_launches, spatial["S"] = phase_spatial()
    n_shapes, n_shapes8, n_shapes8_here = phase_launched_shapes()
    n_br_shapes, n_br_here = phase_bias_relu_shapes()

    main_rows = [r for r in rows if r["path"] == "dense"]
    tiled_rows = [r for r in rows if r["path"].startswith("tiled")]
    # S1 and S5: per rank per step, the forward and dx at the band-plus-halo shapes
    sp_rows = [r for r in rows if r["path"] == "spatial"]
    sp_bwd_rows = [r for r in bwd_rows if r["path"] == "spatial"]
    spy_rows = [r for r in rows if r["path"] == "spatial_yolo"]
    spy_bwd_rows = [r for r in bwd_rows if r["path"] == "spatial_yolo"]
    bwd_rows = [r for r in bwd_rows if r["path"] == "train"]
    train_paths = {"train": train_launches, "train_binary": binary_launches,
                   # the slice's main path: 2 epochs of train_model with validation
                   "train_model": train_model_launches,
                   **{f"train_{k}": v for k, v in variant_launches.items()},
                   "train_remat": remat_launches,
                   # D1, D2: the data-parallel step at world size 1, and each rank of two
                   "train_dp_world1": dp1_launches, **dp2_launches,
                   # S1-S3, S5: each rank of the row-sharded steps
                   **{f"train_{k}": v for k, v in sp_launches.items() if k[:2] not in ("S4", "S6")}}
    # C1-C5: UNet++ and YOLOv8-seg serving, tiled, train, export and int8
    family_paths = {**pp_launches, **pp_train_launches, **yolo_launches,
                    **{k: fwd_launches(v["conv3x3_nhwc"], 0) for k, v in yolo8_launches.items()}}
    train_paths.update({k: v for k, v in family_paths.items() if "train" in k})
    by_path = {"predict": launches["conv3x3_nhwc"],
               **{k: v["conv3x3_nhwc"] for k, v in train_paths.items()},
               "tiled": tiled_launches["conv3x3_nhwc"],
               "pipeline": pipeline_launches.get("conv3x3_nhwc", 0),
               "export": export_launches["conv3x3_nhwc"],
               # D3: data-parallel serving, two replicas
               "dp_predict": dp3_launches["dense"]["conv3x3_nhwc"],
               "dp_tiled": dp3_launches["tiled"]["conv3x3_nhwc"],
               # S4, S6: each rank of the row-sharded eval forward of one scan
               **{k: v["conv3x3_nhwc"] for k, v in sp_launches.items() if k[:2] in ("S4", "S6")},
               **{k: v["conv3x3_nhwc"] for k, v in family_paths.items() if "train" not in k}}
    # the one-pass bias + ReLU by path: every served UNet / UNet++ path, and
    # none in training or YOLO
    br_by_path = {"predict": launches["bias_relu_nhwc"],
                  **{k: v["bias_relu_nhwc"] for k, v in train_paths.items()},
                  "tiled": tiled_launches["bias_relu_nhwc"],
                  "pipeline": pipeline_launches.get("bias_relu_nhwc", 0),
                  "export": export_launches["bias_relu_nhwc"],
                  "dp_predict": dp3_launches["dense"]["bias_relu_nhwc"],
                  "dp_tiled": dp3_launches["tiled"]["bias_relu_nhwc"],
                  **{k: v["bias_relu_nhwc"] for k, v in sp_launches.items()
                     if k[:2] in ("S4", "S6")},
                  **{k: v["bias_relu_nhwc"] for k, v in family_paths.items()
                     if "train" not in k}}
    source = "unet_medical_image_contour_segmentation_torch/csrc/conv3x3.cu"
    tpu = "unet_medical_image_contour_segmentation_tpu"
    pallas = f"{tpu}/ops/pallas_conv.py"
    # the main path's 18 convs as the int8 forward runs them: the Up conv1s split
    dense8 = [r for r in int8_rows if r["path"] == "dense"]
    split8 = {r["name"].split()[0]: r for r in int8_rows if r["path"] == "split"}
    fwd8 = [split8.get(r["name"], r) for r in dense8]
    int8_by_path = {"int8_predict": int8_launches["conv3x3_int8"],
                    "int8_tiled": int8_tiled_launches["conv3x3_int8"],
                    "int8_pipeline": int8_pipe_launches.get("conv3x3_int8", 0),
                    "int8_export": export8_launches["conv3x3_int8"],
                    "dp_int8": dp3_launches["int8"]["conv3x3_int8"],
                    **{k: v["conv3x3_int8"] for k, v in pp8_launches.items()},
                    **{k: v["conv3x3_int8"] for k, v in yolo8_launches.items()}}
    # the SiLU instantiations (C5): per proto-scope forward (p_c1..3) and per
    # full-scope forward (each shape as often as the forward runs it)
    silu8 = {r["name"].removeprefix("yolo "): r for r in int8_rows if r["path"] == "yolo"}
    counts = {name: n for name, *_, n in YOLO_SILU_CONVS}
    proto8 = [silu8[name] for name in YOLO_PROTO_CONVS]

    def per_full(key):
        if any(r[key] is None for r in silu8.values()):
            return None
        return sum(counts[name] * r[key] for name, r in silu8.items())
    yolo_rows = [r for r in rows if r["path"] == "yolo"]
    kernels = [{
        "name": "conv3x3_nhwc",
        "route": "cuda",
        "source": source,
        "replaces": f"{pallas}:133",
        # the launches of every path: dense predict, train, tiled predict,
        # pipeline, export, and unet_pp_s / yolov8_seg_s (C1-C4)
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_err,
        # per unet_s forward: the sum over the main path's shapes
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "shapes": shape_rows(main_rows),
        # the distinct shapes launched inside the counted windows, all checked
        "launch_shapes_checked": n_shapes,
        # per window-group forward of the tiled path, by window size
        "tiled": {f"{win}": {"batch": b, **{k: sum(r[k] for r in tiled_rows
                                                  if r["path"] == f"tiled{win}")
                                            for k in ("ms", "bound_ms", "plain_ms",
                                                      "library_ms")}}
                  for b, win in TILED_WINDOWS},
        "tiled_shapes": shape_rows(tiled_rows),
        # yolov8_seg_s's convs at (8, 512²) that unet_s has no shape for
        "yolo_shapes": shape_rows(yolo_rows),
        # per rank per S1 step (unet_s, 2 x 1024², 2 bands): its band and halo rows
        "spatial": {k: sum(r[k] for r in sp_rows) for k in ("ms", "bound_ms", "plain_ms",
                                                              "library_ms")},
        "spatial_shapes": shape_rows(sp_rows),
        # per rank per S5 step (yolov8_seg_s, 2 x 1024², 2 bands)
        "spatial_yolo": {k: sum(r[k] for r in spy_rows) for k in ("ms", "bound_ms", "plain_ms",
                                                                    "library_ms")},
        "spatial_yolo_shapes": shape_rows(spy_rows),
    }, {
        # the int8 conv with its epilogue, per unet_s int8 forward (8, 512², 18 convs)
        "name": "conv3x3_int8",
        "route": "cuda",
        "source": "unet_medical_image_contour_segmentation_torch/csrc/conv3x3_int8.cu",
        "replaces": f"{tpu}/ops/wide.py:255 and {tpu}/models/quantize.py:65",
        "launches": sum(int8_by_path.values()),
        "launches_by_path": int8_by_path,
        "max_abs_err": int8_err,
        # per int8 forward: the 18 convs as the main path runs them (Up conv1 split)
        "ms": sum(r["ms"] for r in fwd8),
        "plain_ms": sum(r["plain_ms"] for r in fwd8),
        "bound_ms": sum(r["bound_ms"] for r in fwd8),
        "bound_by": max(("bytes", "operations"), key=lambda k: sum(
            r["bound_ms"] for r in fwd8 if r["bound_by"] == k)),
        # no PyTorch call computes an int8 convolution on CUDA; torch._int_mm
        # on the im2col patch times a GEMM of the same K and N (no halo, no
        # epilogue), a yardstick for the main loop only
        "library_ms": None,
        "ms_one_input": sum(r["ms"] for r in dense8),
        "int_mm_ms": (sum(r["int_mm_ms"] for r in fwd8)
                      if all(r["int_mm_ms"] is not None for r in fwd8) else None),
        "bf16_path_ms": sum(r["bf16_path_ms"] for r in fwd8),
        "shapes": [dict(shape_row(r), out=r["out"], cin2=r["cin2"],
                        bf16_path_ms=r["bf16_path_ms"], int_mm_ms=r["int_mm_ms"],
                        bound_by=r["bound_by"], kernel=r["kernel"], ptxas=r["ptxas"])
                   for r in dense8 + list(split8.values())],
        # the SiLU epilogues (yolov8_seg_s, C5): per proto-scope forward and per
        # full-scope forward at (8, 512²), and per shape
        "silu": {
            "proto": {k: sum(r[k] for r in proto8)
                      for k in ("ms", "plain_ms", "bound_ms", "bf16_path_ms")}
            | {"int_mm_ms": (sum(r["int_mm_ms"] for r in proto8)
                             if all(r["int_mm_ms"] is not None for r in proto8) else None)},
            "full": {k: per_full(k) for k in ("ms", "plain_ms", "bound_ms", "bf16_path_ms",
                                              "int_mm_ms")},
            "shapes": [dict(shape_row(r), out=r["out"], per_full_forward=counts[name],
                            plain_ms=r["plain_ms"], bf16_path_ms=r["bf16_path_ms"],
                            int_mm_ms=r["int_mm_ms"], bound_by=r["bound_by"],
                            kernel=r["kernel"], ptxas=r["ptxas"])
                       for name, r in silu8.items()],
        },
        "launch_shapes_checked": n_shapes8,
        "launch_shapes_checked_in_phase_17": n_shapes8_here,
    }, {
        # the same kernel as the input gradient in the train step's backward
        "name": "conv3x3_nhwc_dx",
        "route": "cuda",
        "source": source,
        "replaces": f"{pallas}:183",
        # the launches of every train path: multiclass, binary, unet_sa,
        # bilinear, remat, unet_pp_s (plain, remat), yolov8_seg_s
        "launches": sum(v["conv3x3_nhwc_dx"] for v in train_paths.values()),
        "launches_by_path": {k: v["conv3x3_nhwc_dx"] for k, v in train_paths.items()},
        "max_abs_err": bwd_err,
        # per unet_s train step: the sum over the training shapes
        "ms": sum(r["ms"] for r in bwd_rows),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows),
        "bound_ms": sum(r["bound_ms"] for r in bwd_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd_rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in bwd_rows),
        "shapes": shape_rows(bwd_rows),
        "spatial": {k: sum(r[k] for r in sp_bwd_rows) for k in ("ms", "bound_ms", "plain_ms",
                                                                  "library_ms")},
        "spatial_shapes": shape_rows(sp_bwd_rows),
        "spatial_yolo": {k: sum(r[k] for r in spy_bwd_rows) for k in ("ms", "bound_ms",
                                                                        "plain_ms", "library_ms")},
        "spatial_yolo_shapes": shape_rows(spy_bwd_rows),
    }, {
        # the bias add and ReLU of the folded 3x3 convs (no TPU kernel: XLA
        # fuses them into the conv there), per shape
        "name": "bias_relu_nhwc",
        "route": "cuda",
        "source": "unet_medical_image_contour_segmentation_torch/csrc/bias_relu.cu",
        "replaces": None,
        # 18 a served UNet forward, 30 a UNet++ one, none in training
        "launches": sum(br_by_path.values()),
        "launches_by_path": br_by_path,
        # the distinct shapes launched inside the counted windows, all held
        # bit for bit against torch.relu(y + b), those of phase 18 among them
        "launch_shapes_checked": n_br_shapes,
        "launch_shapes_checked_late": n_br_here,
        "shapes": [dict(shape_row(r), **{k: r[k] for k in (
            "host_us", "library_host_us", "small_host_us", "small_library_host_us")})
                   for r in bias_relu_rows],
    }]
    fwd, k8 = kernels[0], kernels[1]
    int_mm = "refused" if k8["int_mm_ms"] is None else f"{k8['int_mm_ms']:.4f} ms"
    log(f"[int8-kernels] per int8 forward (Up conv1 split): kernel {k8['ms']:.4f} ms (all 18 "
        f"one-input {k8['ms_one_input']:.4f}), bound {k8['bound_ms']:.4f} ms ({k8['bound_by']}; "
        f"roofline {k8['bound_ms'] / k8['ms']:.1%}), bf16 path {k8['bf16_path_ms']:.4f} ms, "
        f"kernel / bf16 path {k8['ms'] / k8['bf16_path_ms']:.3f}, torch._int_mm {int_mm}")
    for scope, t in k8["silu"].items():
        if scope == "shapes":
            continue
        int_mm = "refused" if t["int_mm_ms"] is None else f"{t['int_mm_ms']:.4f} ms"
        log(f"[int8-kernels] SiLU, per yolov8_seg_s {scope}-scope int8 forward: kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (roofline "
            f"{t['bound_ms'] / t['ms']:.1%}), plain {t['plain_ms']:.4f} ms, bf16 path "
            f"{t['bf16_path_ms']:.4f} ms, torch._int_mm {int_mm}")
    log(f"[kernels] per forward: kernel {fwd['ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
        f"(roofline {fwd['bound_ms'] / fwd['ms']:.1%}), F.conv2d {fwd['library_ms']:.4f} ms, "
        f"kernel / library {fwd['ms'] / fwd['library_ms']:.3f}")
    dx = kernels[2]
    log(f"[backward] per train step: dx kernel {dx['ms']:.4f} ms, bound "
        f"{dx['bound_ms']:.4f} ms, cuDNN dgrad {dx['library_ms']:.4f} ms, "
        f"kernel / library {dx['ms'] / dx['library_ms']:.3f}; dw (cuDNN "
        f"wgrad) {sum(r['dw_library_ms'] for r in bwd_rows):.4f} ms, bound "
        f"{sum(r['dw_bound_ms'] for r in bwd_rows):.4f} ms")
    for (kernel, what), (key, step) in itertools.product(
            ((fwd, "forward"), (dx, "dx")), (("spatial", "S1"), ("spatial_yolo", "S5"))):
        t = kernel[key]
        log(f"[kernels] {what} per rank per {step} step at the band-plus-halo shapes: kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (roofline "
            f"{t['bound_ms'] / t['ms']:.1%}), plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms")
    for win, t in fwd["tiled"].items():
        log(f"[kernels] per tiled forward of {t['batch']} windows of {win}²: kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (roofline "
            f"{t['bound_ms'] / t['ms']:.1%}), plain {t['plain_ms']:.4f} ms, F.conv2d "
            f"{t['library_ms']:.4f} ms")
    log(f"[main] {json.dumps(main)}")
    log(f"[train] {json.dumps(train)}")
    log(f"[build-dirs] {json.dumps(build_dirs)}")
    log(f"[tiled] {json.dumps(tiled)}")
    log(f"[pipeline] {json.dumps(pipeline)}")
    log(f"[int8-main] {json.dumps(int8_main)}")
    log(f"[export] {json.dumps(export)}")
    log(f"[families] {json.dumps(pp)}")
    log(f"[dp] {json.dumps(dp)}")
    log(f"[spatial] {json.dumps(spatial)}")
    log(f"[time] {time.perf_counter() - t_start:.1f} s from the device check to the result")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
