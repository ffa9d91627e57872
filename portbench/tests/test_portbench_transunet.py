"""The TransUNet cell: its configuration against the port, the frozen FLOPs
count by hand, an attention call's bound, and the serving limit against the
lower-precision fault (the plain reference in fp8 in the program's place,
``control_fp8.py``), at the small size on the CPU."""

import torch

from portbench import control_fp8, flops, flops_transunet, harness, traffic
from portbench.reference import transunet as ref

from .small import small_spec

CPU = torch.device("cpu")
CELL = "transunet_r50_b16.serve_batch"
SEED = 2**33 + 29


def test_configuration_is_the_ports_published_preset():
    spec = harness.cell_spec(CELL)
    cfg = spec.config
    assert cfg["family"] == "transunet" and cfg["reduced"] == [] and cfg["bilinear"]
    assert ref.parameter_count(cfg) == cfg["parameters"] == 105_912_115
    assert ref.preset(cfg)["skips"] == [512, 256, 64, 0]
    assert cfg["widths"] == [64, 256, 512, 1024, 768]


def test_small_cut_loads_the_reference_weights_strictly():
    # the small cut keeps the published preset: only the slices shrink
    spec = small_spec(CELL, compute_dtype="float32")
    assert spec.config["model"] == "transunet_r50_b16" and spec.slices["height"] == 64
    sd = ref.make_state_dict(spec.config, traffic.seeded(5, 0, CPU), CPU)
    port = harness.port_model(spec, sd, CPU).state_dict()
    assert list(port) == list(sd) and all(torch.equal(port[k], sd[k]) for k in sd)
    assert ref.parameter_count(spec.config) == spec.config["parameters"]


def test_flops_parts_at_512():
    parts = flops_transunet.forward_flops_parts(harness.cell_spec(CELL).config)
    gflop = {k: round(v / 1e9, 1) for k, v in parts.items()}
    assert gflop == {"resnet": 41.0, "patch_embedding": 1.6, "transformer": 212.6,
                     "attention_products": 38.7, "decoder": 81.2}
    # one transformer layer by hand: q, k, v, out; the MLP; q kᵀ and the weighted sum
    n, d, m = 1024, 768, 3072
    assert parts["transformer"] == 12 * (8 * n * d * d + 4 * n * d * m + 4 * n * n * d)
    assert round(flops_transunet.forward_flops(harness.cell_spec(CELL).config) / 1e9, 1) == 336.3


def test_attention_bound_at_the_cells_shape():
    bound = flops_transunet.attention_bound_s(8, 12, 1024, 64, flops.PEAK_FLOPS["bfloat16"],
                                              flops.PEAK_BYTES_PER_S)
    assert abs(bound - 4 * 8 * 12 * 1024 ** 2 * 64 / 989e12) < 1e-12
    assert round(bound * 1e6, 1) == 26.1


def test_sound_run_passes_and_fp8_fails_the_limit():
    # the full preset at 64² (its position embeddings resampled to the 4x4
    # grid): the program in f32 within the limit, the reference in fp8 in
    # its place, through the same driver and comparison, far outside it
    spec = small_spec(CELL, compute_dtype="float32")
    sound = harness.execute(spec, SEED, 0.3, False, CPU)
    assert sound.correct
    fault = control_fp8.execute(small_spec(CELL), SEED, 0.3, CPU)
    limit = spec.cell["limits"]["mean_logit_gap"]
    assert not fault.correct and fault.readings["mean_logit_gap"] > limit
    assert sound.readings["mean_logit_gap"] < limit / 10
    assert harness.port_model is not control_fp8.served_in_fp8  # restored
