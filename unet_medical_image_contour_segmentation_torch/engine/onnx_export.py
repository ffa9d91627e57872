"""ONNX export of the UNet family, UNet++ and YOLOv8-seg: the reference's
deployment contract.

The port's own copy of the JAX package's ``engine/onnx_export.py`` (the
protobuf writer, the UNet graph builder, the parser and the torch-backed
executor), fed the port's weights through
``models/torch_compat.py:params_from_state_dict``.  The reference ships
``torch.onnx.export(opset 11, dynamic batch/H/W axes)``
(the reference's ``export_model.py:30-46``); no ``onnx`` package is needed,
the artifact is emitted directly: a minimal protobuf writer plus graph
builders that lower the eval-mode forwards to ONNX ops:

    Conv / BatchNormalization / Relu / MaxPool / ConvTranspose / Resize
    (linear, align_corners; nearest, asymmetric) / ReduceMean / ReduceMax /
    Concat / Slice / Add / Sigmoid / Mul (YOLO's SiLU is Sigmoid + Mul)

Weights come from the JAX-layout pytrees (HWIO -> OIHW); tensors are NCHW
with dynamic ``batch``/``height``/``width`` dim_params, exactly like the
reference's dynamic_axes.  On the same weights the bytes are the JAX
package's.  The file parses back with :func:`parse_model` and the graph
executes under :func:`run_with_torch`, which validates both the encoding
and the graph semantics without an onnxruntime.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["export_onnx", "build_unet_onnx", "build_unet_pp_onnx", "build_yolov8_onnx",
           "parse_model", "run_with_torch"]

# -- tiny protobuf writer -----------------------------------------------------

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, _WIRE_VARINT) + _varint(v)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(data)) + data


def _f_string(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


def _f_packed_i64(field: int, vals: Sequence[int]) -> bytes:
    body = b"".join(_varint(v) for v in vals)
    return _f_bytes(field, body)


# -- ONNX message constructors (field numbers from onnx.proto) ----------------

FLOAT, INT64 = 1, 7  # TensorProto.DataType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype == np.int64:
        dtype = INT64
    else:
        arr = arr.astype(np.float32)
        dtype = FLOAT
    out = _f_packed_i64(1, list(arr.shape))          # dims
    out += _f_varint(2, dtype)                        # data_type
    out += _f_string(8, name)                         # name
    out += _f_bytes(9, arr.tobytes())                 # raw_data (little-endian)
    return out


def _attr(name: str, value) -> bytes:
    out = _f_string(1, name)
    if isinstance(value, float):
        out += _tag(2, _WIRE_I32) + struct.pack("<f", value)
        out += _f_varint(20, ATTR_FLOAT)
    elif isinstance(value, int):
        out += _f_varint(3, value)
        out += _f_varint(20, ATTR_INT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode())
        out += _f_varint(20, ATTR_STRING)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        out += b"".join(_f_varint(8, v) for v in value)  # ints (unpacked ok)
        out += _f_varint(20, ATTR_INTS)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_tag(7, _WIRE_I32) + struct.pack("<f", float(v)) for v in value)
        out += _f_varint(20, ATTR_FLOATS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", **attrs) -> bytes:
    out = b"".join(_f_string(1, i) for i in inputs)
    out += b"".join(_f_string(2, o) for o in outputs)
    if name:
        out += _f_string(3, name)
    out += _f_string(4, op)
    out += b"".join(_f_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _dim(value: Union[int, str]) -> bytes:
    if isinstance(value, int):
        return _f_varint(1, value)
    return _f_string(2, value)


def _value_info(name: str, dims: Sequence[Union[int, str]], elem_type=FLOAT) -> bytes:
    shape = b"".join(_f_bytes(1, _dim(d)) for d in dims)
    ttype = _f_varint(1, elem_type) + _f_bytes(2, shape)
    return _f_string(1, name) + _f_bytes(2, _f_bytes(1, ttype))


def _graph(nodes: List[bytes], name: str, initializers: List[bytes],
           inputs: List[bytes], outputs: List[bytes]) -> bytes:
    out = b"".join(_f_bytes(1, n) for n in nodes)
    out += _f_string(2, name)
    out += b"".join(_f_bytes(5, t) for t in initializers)
    out += b"".join(_f_bytes(11, i) for i in inputs)
    out += b"".join(_f_bytes(12, o) for o in outputs)
    return out


def _model(graph: bytes, opset: int = 11) -> bytes:
    out = _f_varint(1, 6)                                  # ir_version 6
    # producer_name: the JAX package's, so that both write the same bytes
    out += _f_string(2, "umics-tpu")
    out += _f_string(3, "1.0")
    out += _f_bytes(7, graph)
    out += _f_bytes(8, _f_string(1, "") + _f_varint(2, opset))  # opset_import
    return out


# -- UNet graph builder --------------------------------------------------------

class _Builder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, hint: str, arr: np.ndarray) -> str:
        n = self.name(hint)
        self.inits.append(_tensor(n, arr))
        return n

    def add(self, op: str, inputs, n_out: int = 1, **attrs) -> Union[str, List[str]]:
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(_node(op, inputs, outs, name=self.name(op), **attrs))
        return outs[0] if n_out == 1 else outs


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv(b: _Builder, x: str, w_hwio, bias=None, pads: int = 1,
          stride: int = 1) -> str:
    w = _np(w_hwio).transpose(3, 2, 0, 1)  # HWIO -> OIHW
    ins = [x, b.init("w", w)]
    if bias is not None:
        ins.append(b.init("b", _np(bias)))
    k = w.shape[2]
    return b.add("Conv", ins, kernel_shape=[k, w.shape[3]],
                 pads=[pads, pads, pads, pads], strides=[stride, stride])


def _bn(b: _Builder, x: str, p, s) -> str:
    ins = [x, b.init("gamma", _np(p["scale"])), b.init("beta", _np(p["bias"])),
           b.init("mean", _np(s["mean"])), b.init("var", _np(s["var"]))]
    return b.add("BatchNormalization", ins, epsilon=1e-5, momentum=0.9)


def _double_conv(b: _Builder, x: str, p, s) -> str:
    y = _conv(b, x, p["conv1"]["w"])
    y = b.add("Relu", [_bn(b, y, p["bn1"], s["bn1"])])
    y = _conv(b, y, p["conv2"]["w"])
    return b.add("Relu", [_bn(b, y, p["bn2"], s["bn2"])])


def _attention(b: _Builder, skip: str, p) -> str:
    avg = b.add("ReduceMean", [skip], axes=[1], keepdims=1)
    mx = b.add("ReduceMax", [skip], axes=[1], keepdims=1)
    feats = b.add("Concat", [avg, mx], axis=1)
    att = _conv(b, feats, p["conv"]["w"], pads=3)
    return b.add("Mul", [skip, b.add("Sigmoid", [att])])


def build_unet_onnx(params, bn_state, *, n_channels: int, n_classes: int,
                    opset: int = 11) -> bytes:
    """Eval-mode UNet-family forward -> ONNX ModelProto bytes.

    Requires H and W multiples of 16 at runtime (4 pooling levels), the same
    contract the exported program encodes in its shapes.  Works for any widths
    / bilinear / attention combination — everything is read off the pytrees.
    """
    b = _Builder()
    x = _double_conv(b, "input", params["inc"], bn_state["inc"])
    skips = [x]
    for i in range(1, 5):
        pooled = b.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
        x = _double_conv(b, pooled, params[f"down{i}"], bn_state[f"down{i}"])
        if i < 4:
            skips.append(x)

    for i in range(1, 5):
        p = params[f"up{i}"]
        skip = skips[4 - i]
        if "upconv" in p:
            w = _np(p["upconv"]["w"]).transpose(2, 3, 0, 1)  # HWIO -> IOHW
            ins = [x, b.init("wt", w)]
            if p["upconv"].get("b") is not None:
                ins.append(b.init("bt", _np(p["upconv"]["b"])))
            x = b.add("ConvTranspose", ins, kernel_shape=[2, 2], strides=[2, 2])
        else:
            scales = b.init("scales", _np([1.0, 1.0, 2.0, 2.0]))
            roi = b.init("roi", np.zeros((0,), np.float32))
            x = b.add("Resize", [x, roi, scales], mode="linear",
                      coordinate_transformation_mode="align_corners")
        if "att" in p:
            skip = _attention(b, skip, p["att"])
        cat = b.add("Concat", [skip, x], axis=1)
        x = _double_conv(b, cat, p["conv"], bn_state[f"up{i}"]["conv"])

    outc = params["outc"]
    logits = _conv(b, x, outc["w"], bias=outc.get("b"), pads=0)
    # rename the final value to "output" via an Identity
    b.nodes.append(_node("Identity", [logits], ["output"], name="out"))

    graph = _graph(
        b.nodes, "unet",
        b.inits,
        [_value_info("input", ["batch", n_channels, "height", "width"])],
        [_value_info("output", ["batch", n_classes, "height", "width"])],
    )
    return _model(graph, opset)


def _conv_transpose(b: _Builder, x: str, p) -> str:
    w = _np(p["w"]).transpose(2, 3, 0, 1)  # HWIO -> IOHW
    ins = [x, b.init("wt", w)]
    if p.get("b") is not None:
        ins.append(b.init("bt", _np(p["b"])))
    return b.add("ConvTranspose", ins, kernel_shape=[2, 2], strides=[2, 2])


def _resize2(b: _Builder, x: str, mode: str) -> str:
    scales = b.init("scales", _np([1.0, 1.0, 2.0, 2.0]))
    roi = b.init("roi", np.zeros((0,), np.float32))
    if mode == "nearest":
        # asymmetric+floor == jnp.repeat(2) replication semantics
        return b.add("Resize", [x, roi, scales], mode="nearest",
                     coordinate_transformation_mode="asymmetric",
                     nearest_mode="floor")
    return b.add("Resize", [x, roi, scales], mode="linear",
                 coordinate_transformation_mode="align_corners")


def build_unet_pp_onnx(params, bn_state, *, n_channels: int, n_classes: int,
                       bilinear: bool = False, depth: Optional[int] = None,
                       opset: int = 11) -> bytes:
    """Eval-mode UNet++ forward -> ONNX ModelProto bytes.

    Mirrors models/unet_nested.py's ``_apply_nhwc`` (the reference *imports*
    UNetPlusPlus from a file absent from its repo, ``train.py:16``; this is
    the deployment contract for our runnable equivalent).  Requires H and W
    multiples of 2^(depth-1) at runtime, like the StableHLO export.
    """
    if depth is None:  # infer from the params (x0_0 .. x{d-1}_0 backbone)
        depth = 1 + max(int(k[1:].split("_")[0]) for k in params if k.startswith("x"))
    b = _Builder()
    deep_supervision = "outc" not in params

    nodes: Dict[Tuple[int, int], str] = {}
    x = "input"
    for i in range(depth):
        inp = x if i == 0 else b.add("MaxPool", [nodes[(i - 1, 0)]],
                                     kernel_shape=[2, 2], strides=[2, 2])
        nodes[(i, 0)] = _double_conv(b, inp, params[f"x{i}_0"], bn_state[f"x{i}_0"])

    for j in range(1, depth):
        for i in range(depth - j):
            skips = [nodes[(i, k)] for k in range(j)]
            src = nodes[(i + 1, j - 1)]
            if bilinear:
                upped = _resize2(b, src, "linear")
            else:
                upped = _conv_transpose(b, src, params[f"up{i}_{j}"])
            cat = b.add("Concat", skips + [upped], axis=1)
            nodes[(i, j)] = _double_conv(b, cat, params[f"x{i}_{j}"],
                                         bn_state[f"x{i}_{j}"])

    if deep_supervision:
        heads = [
            _conv(b, nodes[(0, j)], params[f"out{j}"]["w"],
                  bias=params[f"out{j}"].get("b"), pads=0)
            for j in range(1, depth)
        ]
        acc = heads[0]
        for h in heads[1:]:
            acc = b.add("Add", [acc, h])
        logits = b.add("Mul", [acc, b.init("invn", _np(1.0 / len(heads)))])
    else:
        outc = params["outc"]
        logits = _conv(b, nodes[(0, depth - 1)], outc["w"], bias=outc.get("b"),
                       pads=0)
    b.nodes.append(_node("Identity", [logits], ["output"], name="out"))

    graph = _graph(
        b.nodes, "unet_pp", b.inits,
        [_value_info("input", ["batch", n_channels, "height", "width"])],
        [_value_info("output", ["batch", n_classes, "height", "width"])],
    )
    return _model(graph, opset)


def _silu(b: _Builder, x: str) -> str:
    return b.add("Mul", [x, b.add("Sigmoid", [x])])


def _cbs_onnx(b: _Builder, x: str, p, s, stride: int = 1) -> str:
    k = _np(p["conv"]["w"]).shape[0]
    y = _conv(b, x, p["conv"]["w"], pads=k // 2, stride=stride)
    return _silu(b, _bn(b, y, p["bn"], s["bn"]))


def _slice_ch(b: _Builder, x: str, start: int, end: int) -> str:
    return b.add("Slice", [
        x,
        b.init("starts", np.asarray([start], np.int64)),
        b.init("ends", np.asarray([end], np.int64)),
        b.init("axes", np.asarray([1], np.int64)),
    ])


def _c2f_onnx(b: _Builder, x: str, p, s, n: int) -> str:
    y = _cbs_onnx(b, x, p["cv1"], s["cv1"])
    c = _np(p["cv1"]["conv"]["w"]).shape[-1] // 2
    parts = [_slice_ch(b, y, 0, c), _slice_ch(b, y, c, 2 * c)]
    for i in range(n):
        t = _cbs_onnx(b, parts[-1], p[f"m{i}"]["cv1"], s[f"m{i}"]["cv1"])
        t = _cbs_onnx(b, t, p[f"m{i}"]["cv2"], s[f"m{i}"]["cv2"])
        parts.append(b.add("Add", [parts[-1], t]))  # residual shortcut
    cat = b.add("Concat", parts, axis=1)
    return _cbs_onnx(b, cat, p["cv2"], s["cv2"])


def build_yolov8_onnx(params, bn_state, *, n_channels: int, n_classes: int,
                      depths: Sequence[int] = (1, 2, 2, 1),
                      opset: int = 11) -> bytes:
    """Eval-mode YOLOv8-seg forward -> ONNX ModelProto bytes.

    Mirrors models/yolov8_seg.py's ``_apply_nhwc`` (the reference imports
    YOLOv8_Seg_S from an absent ``yolo/`` dir, ``train.py:18`` /
    ``export_model.py:5``).  SiLU is emitted as Sigmoid+Mul (opset 11 has no
    native SiLU).  Requires H and W multiples of 32 at runtime (stride-32
    backbone).
    """
    b = _Builder()
    p, s = params, bn_state

    y = _cbs_onnx(b, "input", p["stem"], s["stem"], stride=2)
    feats = {}
    for i in range(4):
        y = _cbs_onnx(b, y, p[f"down{i}"], s[f"down{i}"], stride=2)
        y = _c2f_onnx(b, y, p[f"c2f{i}"], s[f"c2f{i}"], depths[i])
        feats[i] = y

    # SPPF: cv1 -> 5x5 s1 SAME maxpool x3 -> concat -> cv2
    y = _cbs_onnx(b, y, p["sppf"]["cv1"], s["sppf"]["cv1"])
    pools = [y]
    for _ in range(3):
        pools.append(b.add("MaxPool", [pools[-1]], kernel_shape=[5, 5],
                           strides=[1, 1], pads=[2, 2, 2, 2]))
    y = _cbs_onnx(b, b.add("Concat", pools, axis=1), p["sppf"]["cv2"],
                  s["sppf"]["cv2"])

    # FPN top-down (nearest x2 upsample)
    p4 = _c2f_onnx(b, b.add("Concat", [_resize2(b, y, "nearest"), feats[2]],
                            axis=1), p["n4"], s["n4"], depths[2])
    p3 = _c2f_onnx(b, b.add("Concat", [_resize2(b, p4, "nearest"), feats[1]],
                            axis=1), p["n3"], s["n3"], depths[1])

    # proto head back to full resolution
    t = _conv_transpose(b, p3, p["p_up1"])
    t = _cbs_onnx(b, t, p["p_c1"], s["p_c1"])
    t = _conv_transpose(b, t, p["p_up2"])
    t = _cbs_onnx(b, t, p["p_c2"], s["p_c2"])
    t = _conv_transpose(b, t, p["p_up3"])
    t = _cbs_onnx(b, t, p["p_c3"], s["p_c3"])
    logits = _conv(b, t, p["head"]["w"], bias=p["head"].get("b"), pads=0)
    b.nodes.append(_node("Identity", [logits], ["output"], name="out"))

    graph = _graph(
        b.nodes, "yolov8_seg", b.inits,
        [_value_info("input", ["batch", n_channels, "height", "width"])],
        [_value_info("output", ["batch", n_classes, "height", "width"])],
    )
    return _model(graph, opset)


def export_onnx(model, path: str, *, opset: int = 11) -> bytes:
    """Write the ONNX artifact of a port model (its eval forward, BN as
    BatchNormalization nodes) to ``path``; returns the bytes.  The builder
    goes by the model's name, as JAX's ``export_onnx``: UNet++, YOLOv8-seg,
    else the UNet family."""
    from ..models.torch_compat import params_from_state_dict

    params, bn_state, _ = params_from_state_dict(model.state_dict())
    name = getattr(model, "name", "")
    if name.startswith("unet_pp"):
        data = build_unet_pp_onnx(params, bn_state, n_channels=model.n_channels,
                                  n_classes=model.n_classes, bilinear=model.bilinear,
                                  opset=opset)
    elif name.startswith("yolo"):
        data = build_yolov8_onnx(params, bn_state, n_channels=model.n_channels,
                                 n_classes=model.n_classes, depths=model.depths, opset=opset)
    else:
        data = build_unet_onnx(params, bn_state, n_channels=model.n_channels,
                               n_classes=model.n_classes, opset=opset)
    with open(path, "wb") as f:
        f.write(data)
    return data


# -- parser + torch-backed executor (for validation without onnxruntime) ------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _read_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            v, i = _read_varint(buf, i)
        elif wire == _WIRE_LEN:
            n, i = _read_varint(buf, i)
            v = buf[i:i + n]
            i += n
        elif wire == _WIRE_I32:
            v = buf[i:i + 4]
            i += 4
        elif wire == _WIRE_I64:
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _parse_tensor(buf: bytes):
    dims, dtype, name, raw = [], FLOAT, "", b""
    for f, _, v in _read_fields(buf):
        if f == 1:
            if isinstance(v, bytes):  # packed
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    dims.append(d)
            else:
                dims.append(v)
        elif f == 2:
            dtype = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
    np_dtype = {FLOAT: np.float32, INT64: np.int64}[dtype]
    return name, np.frombuffer(raw, np_dtype).reshape(dims)


def _parse_attr(buf: bytes):
    name, val = "", None
    ints, floats = [], []
    for f, w, v in _read_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            val = struct.unpack("<f", v)[0]
        elif f == 3:
            val = v
        elif f == 4:
            val = v.decode()
        elif f == 7:
            floats.append(struct.unpack("<f", v)[0])
        elif f == 8:
            if isinstance(v, bytes):
                i = 0
                while i < len(v):
                    d, i = _read_varint(v, i)
                    ints.append(d)
            else:
                ints.append(v)
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def _parse_node(buf: bytes):
    node = {"input": [], "output": [], "op": "", "attrs": {}}
    for f, _, v in _read_fields(buf):
        if f == 1:
            node["input"].append(v.decode())
        elif f == 2:
            node["output"].append(v.decode())
        elif f == 4:
            node["op"] = v.decode()
        elif f == 5:
            k, val = _parse_attr(v)
            node["attrs"][k] = val
    return node


def parse_model(data: bytes):
    """ModelProto bytes -> {opset, nodes, initializers, input, output} dict."""
    out = {"opset": None, "ir_version": None, "nodes": [], "initializers": {},
           "input": [], "output": []}
    for f, _, v in _read_fields(data):
        if f == 1:
            out["ir_version"] = v
        elif f == 7:
            for gf, _, gv in _read_fields(v):
                if gf == 1:
                    out["nodes"].append(_parse_node(gv))
                elif gf == 5:
                    name, arr = _parse_tensor(gv)
                    out["initializers"][name] = arr
                elif gf == 11:
                    out["input"].append(gv)
                elif gf == 12:
                    out["output"].append(gv)
        elif f == 8:
            for sf, _, sv in _read_fields(v):
                if sf == 2:
                    out["opset"] = sv
    return out


def run_with_torch(data: bytes, x_nchw: np.ndarray) -> np.ndarray:
    """Execute the emitted graph with torch ops (an ONNX-subset interpreter).

    Independent of the builder's in-memory state: everything — topology,
    weights, attributes — is re-read from the serialized bytes, so a pass
    here means the artifact itself is well-formed and semantically right.
    """
    import torch
    import torch.nn.functional as F

    m = parse_model(data)
    env: Dict[str, "torch.Tensor"] = {
        k: torch.from_numpy(v.copy()) for k, v in m["initializers"].items()
    }
    env["input"] = torch.from_numpy(np.asarray(x_nchw, np.float32))

    for n in m["nodes"]:
        op, a = n["op"], n["attrs"]
        ins = [env[i] for i in n["input"]]
        if op == "Conv":
            p = a.get("pads", [0, 0, 0, 0])[0]
            st = a.get("strides", [1, 1])[0]
            y = F.conv2d(ins[0], ins[1], ins[2] if len(ins) > 2 else None,
                         stride=st, padding=p)
        elif op == "ConvTranspose":
            y = F.conv_transpose2d(ins[0], ins[1], ins[2] if len(ins) > 2 else None,
                                   stride=a["strides"][0])
        elif op == "BatchNormalization":
            y = F.batch_norm(ins[0], ins[3], ins[4], ins[1], ins[2],
                             training=False, eps=a["epsilon"])
        elif op == "Relu":
            y = F.relu(ins[0])
        elif op == "MaxPool":
            p = a.get("pads", [0, 0, 0, 0])[0]
            y = F.max_pool2d(ins[0], a["kernel_shape"][0], a["strides"][0],
                             padding=p)
        elif op == "Resize":
            sc = ins[2]
            if a["mode"] == "nearest":
                assert a["coordinate_transformation_mode"] == "asymmetric"
                y = ins[0].repeat_interleave(int(sc[2]), dim=2) \
                          .repeat_interleave(int(sc[3]), dim=3)
            else:
                assert a["mode"] == "linear"
                assert a["coordinate_transformation_mode"] == "align_corners"
                y = F.interpolate(ins[0], scale_factor=(float(sc[2]), float(sc[3])),
                                  mode="bilinear", align_corners=True)
        elif op == "Slice":
            starts, ends, axes = (t.tolist() for t in ins[1:4])
            y = ins[0]
            for st_, en_, ax_ in zip(starts, ends, axes):
                y = y.narrow(int(ax_), int(st_), int(en_) - int(st_))
        elif op == "Add":
            y = ins[0] + ins[1]
        elif op == "Concat":
            y = torch.cat(ins, dim=a["axis"])
        elif op == "ReduceMean":
            y = ins[0].mean(dim=a["axes"][0], keepdim=bool(a["keepdims"]))
        elif op == "ReduceMax":
            y = ins[0].max(dim=a["axes"][0], keepdim=bool(a["keepdims"])).values
        elif op == "Sigmoid":
            y = torch.sigmoid(ins[0])
        elif op == "Mul":
            y = ins[0] * ins[1]
        elif op == "Identity":
            y = ins[0]
        else:
            raise NotImplementedError(op)
        env[n["output"][0]] = y
    return env["output"].numpy()
