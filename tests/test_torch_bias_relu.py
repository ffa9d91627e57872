"""The one-pass bias add and ReLU (``kernels/bias_relu.py``) on the CPU: the
operator's CPU path and fake implementation, ``conv2d(..., relu=True)``,
and the folded UNet and UNet++ forwards, which must give the same bits as
the ``torch.relu(conv2d(x, w, b))`` expression they ran before the pass.
The kernel itself runs on the card (``tests/test_torch_gpu.py``)."""

import copy
import types

import pytest
import torch

from chip_smoke import seeded_model
from unet_medical_image_contour_segmentation_torch.engine.export import (
    export_program,
    load_exported,
)
from unet_medical_image_contour_segmentation_torch.kernels import bias_relu as BR
from unet_medical_image_contour_segmentation_torch.kernels._build import LAUNCHES
from unet_medical_image_contour_segmentation_torch.models.fold_bn import (
    FoldedDoubleConv,
    serving_copy,
)
from unet_medical_image_contour_segmentation_torch.ops.nn import conv2d

DTYPES = [torch.bfloat16, torch.float32]
INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(INT[a.dtype]), b.view(INT[b.dtype]))


def _operands(c: int, dtype, seed: int = 0):
    """y (2, 5, 7, C) and a bias of C, with NaNs in both, -0.0 in both, and
    exact cancellations of y by the bias."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((2, 5, 7, c), generator=g).to(dtype)
    b = torch.randn((c,), generator=g).to(dtype)
    y[0, 0, 0, 0] = float("nan")
    y[1, 2, 3, -1] = -0.0
    y[1, 4, 6] = -b
    b[0] = y[0, 0, 1, 0] = -0.0  # a sum of -0.0
    b[c // 2] = float("nan")
    return y, b


@pytest.mark.parametrize("c", [3, 8, 16, 64, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_path_is_the_plain_pair(dtype, c):
    y, b = _operands(c, dtype)
    y0 = y.clone()
    got = BR.bias_relu_nhwc(y, b)
    assert _bits_equal(got, torch.relu(y + b.to(y.dtype)))
    assert _bits_equal(y, y0)  # the input is left as it was
    assert got.isnan().any()


def test_fake_implementation_gives_shape_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = LAUNCHES["bias_relu_nhwc"]
    with FakeTensorMode():
        for dtype in DTYPES:
            y = torch.empty((3, 40, 24, 16), dtype=dtype)
            out = torch.ops.umics.bias_relu_nhwc(y, torch.empty((16,), dtype=dtype))
            assert (tuple(out.shape), out.dtype) == ((3, 40, 24, 16), dtype)
    assert LAUNCHES["bias_relu_nhwc"] == before


@pytest.mark.parametrize("y,b,error", [
    (torch.zeros(2, 4, 4, 8), torch.zeros(7), ValueError),                      # bias length
    (torch.zeros(2, 4, 8), torch.zeros(8), ValueError),                         # not NHWC
    (torch.zeros(2, 4, 4, 8), torch.zeros(8, dtype=torch.bfloat16), TypeError),  # two dtypes
    (torch.zeros(2, 4, 4, 8, dtype=torch.float16),
     torch.zeros(8, dtype=torch.float16), TypeError),                           # f16
    (torch.zeros(2, 4, 8, 4).transpose(2, 3), torch.zeros(8), ValueError),      # strided
], ids=["bias_length", "not_nhwc", "two_dtypes", "f16", "strided"])
def test_misuse_raises(y, b, error):
    """The checked entry refuses what the op cannot take (the kernel's own
    limit on C is the C side's, tests/test_torch_gpu.py)."""
    with pytest.raises(error):
        BR.bias_relu_nhwc(y, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unchecked_op_is_the_checked_entry(dtype):
    """``op``, which conv2d calls, gives the checked entry's bits and leaves
    the launch counter alone on the CPU."""
    y, b = _operands(16, dtype, seed=3)
    before = LAUNCHES["bias_relu_nhwc"]
    assert _bits_equal(BR.op(y, b), BR.bias_relu_nhwc(y, b))
    assert LAUNCHES["bias_relu_nhwc"] == before


@pytest.mark.parametrize("cin", [1, 16])  # the inc conv on F.conv2d; a routed conv
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv2d_relu_is_relu_of_conv2d(dtype, cin):
    g = torch.Generator().manual_seed(cin)
    x = torch.randn((2, 16, 16, cin), generator=g)
    w = torch.randn((3, 3, cin, 8), generator=g) * 0.3
    b = torch.randn((8,), generator=g)
    kw = dict(padding=1, compute_dtype=dtype)
    assert _bits_equal(conv2d(x, w, b, relu=True, **kw), torch.relu(conv2d(x, w, b, **kw)))
    with pytest.raises(ValueError):  # the pass is the bias add's: no bias, no pass
        conv2d(x, w, relu=True, **kw)


def _parent_forward(self, x, compute_dtype=None, group=None, shard=None):
    """FoldedDoubleConv's forward before the one-pass epilogue."""
    kw = dict(padding=1, compute_dtype=compute_dtype, shard=shard)
    x = torch.relu(conv2d(x, self.w1, self.b1, **kw))
    return torch.relu(conv2d(x, self.w2, self.b2, **kw))


def _served(name: str, dtype):
    model = seeded_model(name, 3)
    net = serving_copy(model, dtype)
    net.compute_dtype = dtype
    return net


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,blocks", [("unet_s", 9), ("unet_pp_s", 15)])
def test_folded_forward_equals_the_parent_expression(name, blocks, dtype):
    """Every folded 3x3 conv takes the pass, and the logits keep their bits;
    only the reference copy runs the parent's forward."""
    net = _served(name, dtype)
    ref = copy.deepcopy(net)
    folded = [m for m in ref.modules() if isinstance(m, FoldedDoubleConv)]
    assert len(folded) == blocks
    for m in folded:
        m.forward = types.MethodType(_parent_forward, m)
    x = torch.rand((2, 64, 64, net.n_channels), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        assert _bits_equal(net(x), ref(x))


def test_exported_program_calls_the_pass():
    """A unet_s serving copy exported on the CPU holds the op once per folded
    conv (18) and runs to the live folded forward's logits."""
    model = seeded_model("unet_s", 3)
    model.compute_dtype = torch.bfloat16
    program = load_exported(export_program(model, example_hw=(32, 32), dynamic_batch=False,
                                           dynamic_hw=False, device="cpu"))
    ops = [n for n in program.graph.nodes
           if n.op == "call_function" and n.target == torch.ops.umics.bias_relu_nhwc.default]
    assert len(ops) == 18
    x = torch.rand((2, 32, 32, 1), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = program.module()(x)
        want = _served("unet_s", torch.bfloat16)(x)
    assert _bits_equal(got, want)
