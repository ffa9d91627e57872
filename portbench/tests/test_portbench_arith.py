"""The frozen arithmetic against the port's own and against a hand count."""

import pytest

from portbench import flops, harness
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_torch.utils.flops import unet_forward_flops


@pytest.mark.parametrize("name", ["unet_s", "unet"])
def test_frozen_flops_equal_the_ports_closed_form(name):
    conf = next(c for c in harness.manifest()["configs"] if c["name"] == name)
    cfg = harness._json(harness.ROOT / conf["file"])
    assert flops.unet_forward_flops(cfg, 512, 512) == unet_forward_flops(get_model(name), 512, 512)


def test_unet_flops_at_512_are_384_8_gflop():
    cfg = harness.cell_spec("unet.serve_batch").config
    assert round(flops.unet_forward_flops(cfg, 512, 512) / 1e9, 1) == 384.8


def test_conv3x3_roofline_count_by_hand():
    # (8, 512, 512, 16) -> 16 in bf16: 2*9*16*16 operations a pixel
    n, h, w, cin, cout = 8, 512, 512, 16, 16
    ops = 2 * 9 * 16 * 16 * 8 * 512 * 512
    by = 8 * 512 * 512 * 16 * 2 + 9 * 16 * 16 * 2 + 8 * 512 * 512 * 16 * 2
    assert flops.conv3x3_ops(n, h, w, cin, cout) == ops
    assert flops.conv3x3_bytes(n, h, w, cin, cout, (2, 2, 2)) == by
    assert flops.conv3x3_bound_s(n, h, w, cin, cout, (2, 2, 2)) == max(ops / 989e12,
                                                                        by / 3.35e12)
    # at these widths the bytes bound it
    assert by / 3.35e12 > ops / 989e12
