"""Time the int8 3x3 conv kernel of one or more checkouts of the port on one
CUDA card, in the order given (parent, change, change, parent compares two).

For each of the 18 convs of unet_s's int8 forward at (8, 512, 512): the
kernel's device time (calls queued behind a sleep, inputs rotated past the
L2) and the host's issue time per call (the median of single calls issued
while the card sleeps), summed per forward.  Each checkout runs in a
process of its own, imports its own package and builds its own kernel; its
output is first held against its own plain version (exactly equal).  A
checkout whose ``conv3x3_int8`` takes a split input (``x2``) gets the Up
conv1s split, as its int8 forward runs them, and also their concatenation
(rows ``<name> cat``); an older one gets the concatenation.  Also times
``cuTensorMapEncodeTiled`` from libcuda (one call from Python, so an
upper bound of what encoding a halo map adds to a launch).

    python3 int8_kernel_ab.py ROOT [ROOT ...] [--out FILE]

Prints the card's name and power limit, one JSON line per run and a table.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# name, Cin, Cout, downsampling, epilogue output: unet_s's 18 int8 convs, as
# chip_smoke.py's INT8_CONVS (not imported: chip_smoke.py imports the port of
# its own checkout, which need not be the one timed)
CONVS = [
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
SPLIT = ("up1.conv1", "up2.conv1", "up3.conv1", "up4.conv1")
BATCH, HW = 8, 512
ROTATE_BYTES = 64 * 2**20
SLEEP_HZ = 2.0e9              # above the H100's highest SM clock
HOST_CALLS = 101
CHILD_TIMEOUT_S = 900


def _import(root: Path):
    sys.path.insert(0, str(root))
    from unet_medical_image_contour_segmentation_torch.kernels import _build
    from unet_medical_image_contour_segmentation_torch.kernels import conv3x3_int8 as k8

    if not Path(k8.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {k8.__file__}, not the checkout at {root}")
    return _build, k8


def _device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of fn(i), the calls queued behind a sleep."""
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(i)
    issue_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((4 * reps * issue_s + 2e-3) * SLEEP_HZ))
    start.record()
    for i in range(reps):
        fn(warmup + i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(torch, fn) -> float:
    """Median host microseconds of one call of fn(i), issued while the card
    sleeps (so that no call waits for the device)."""
    fn(0)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(HOST_CALLS * 300e-6 * SLEEP_HZ))
    times = []
    for i in range(HOST_CALLS):
        t0 = time.perf_counter()
        fn(i)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def _encode_us(torch) -> float | None:
    """Microseconds per cuTensorMapEncodeTiled of a 5-D int8 halo map
    (16, Cin / 16, W, H, B) = (16, 2, 512, 512, 8), box (16, 1, 66, 10, 1),
    called through ctypes (its overhead included); None where libcuda
    refuses it."""
    lib = ctypes.CDLL("libcuda.so.1")
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    x = torch.empty(BATCH * HW * HW * 32, dtype=torch.int8, device="cuda")
    buf = (ctypes.c_uint8 * 256)()
    base = ctypes.addressof(buf)
    tmap = ctypes.c_void_p(base + (-base % 64))
    dims = (u64 * 5)(16, 2, HW, HW, BATCH)
    strides = (u64 * 4)(16, 32, 32 * HW, 32 * HW * HW)
    box = (u32 * 5)(16, 1, 66, 10, 1)
    elem = (u32 * 5)(1, 1, 1, 1, 1)
    # UINT8, rank 5, interleave none, swizzle none, L2 promotion 128B, no NaN fill
    args = (tmap, 0, 5, ctypes.c_void_p(x.data_ptr()), dims, strides, box, elem, 0, 0, 2, 0)
    if lib.cuTensorMapEncodeTiled(*args) != 0:
        return None
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        lib.cuTensorMapEncodeTiled(*args)
    return (time.perf_counter() - t0) / reps * 1e6


def _operands(torch, np, k8, seed: int, b: int, h: int, w: int, cin: int, cout: int):
    """chip_smoke.py's int8_operands, packed by the checkout's own pack_weight."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))
    mul = rng.uniform(0.5, 1.5, cout) * 60.0 / (np.sqrt(9 * cin) * 73.0 ** 2)
    badd = rng.normal(0.0, 30.0, cout)
    return (x.cuda(), k8.pack_weight(wt).cuda(),
            torch.from_numpy(mul.astype(np.float32)).cuda(),
            torch.from_numpy(badd.astype(np.float32)).cuda())


def run_one(root: Path) -> dict:
    import numpy as np
    import torch

    _, k8 = _import(root)
    takes_x2 = "x2" in inspect.signature(k8.conv3x3_int8).parameters
    rows = []
    for i, (name, cin, cout, s, out) in enumerate(CONVS):
        b, h, w = BATCH, HW // s, HW // s
        out_dtype = torch.int8 if out == "int8" else torch.bfloat16
        x, wp, mul, badd = _operands(torch, np, k8, 70 + i, b, h, w, cin, cout)
        forms = [("split", name)] if takes_x2 and name in SPLIT else []
        forms.append(("one", f"{name} cat" if forms else name))
        for form, label in forms:
            xs = [x] + [x.clone() for _ in range(max(1, -(-ROTATE_BYTES // x.numel()) - 1))]
            if form == "split":
                xs = [(t[..., :cin // 2].contiguous(), t[..., cin // 2:].contiguous()) for t in xs]

                def call(j, xs=xs):
                    a, a2 = xs[j % len(xs)]
                    return k8.conv3x3_int8(a, wp, mul, badd, out_dtype, a2)
                ref = k8.conv3x3_int8_reference(xs[0][0], wp, mul, badd, out_dtype, xs[0][1])
            else:
                def call(j, xs=xs):
                    return k8.conv3x3_int8(xs[j % len(xs)], wp, mul, badd, out_dtype)
                ref = k8.conv3x3_int8_reference(x, wp, mul, badd, out_dtype)
            if not torch.equal(call(0), ref):
                raise RuntimeError(f"{root}: the kernel differs from its plain version at "
                                   f"{label}")
            rows.append(dict(name=label, shape=[b, h, w, cin, cout], out=out, form=form,
                             ms=_device_ms(torch, call), host_us=_host_us(torch, call)))
            del xs
    fwd = [r for r in rows if not r["name"].endswith(" cat")]
    return dict(root=str(root), takes_x2=takes_x2, rows=rows,
                forward_ms=sum(r["ms"] for r in fwd),
                forward_host_us=sum(r["host_us"] for r in fwd),
                encode_us=_encode_us(torch))


def build_one(root: Path) -> None:
    _build, _ = _import(root)
    r = _build.build(["conv3x3_int8"])["conv3x3_int8"]
    print(f"[build] {root}: {r.library.name} in {r.seconds:.2f} s", flush=True)


def _child(flag: str, root: Path) -> str:
    proc = subprocess.run([sys.executable, __file__, flag, str(root)], capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"{flag} {root} failed ({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--out", type=Path, help="also write the runs here as JSON lines")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one.resolve())))
        return 0
    if args.build:
        build_one(args.build.resolve())
        return 0
    if not args.roots:
        ap.error("name at least one checkout")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] nvidia-smi: {smi}", flush=True)
    roots = [r.resolve() for r in args.roots]
    with ThreadPoolExecutor(len(set(roots))) as pool:
        for out in pool.map(lambda r: _child("--build", r), sorted(set(roots))):
            print(out, end="", flush=True)
    runs = []
    for root in roots:
        run = json.loads(_child("--one", root).splitlines()[-1])
        run["device"] = smi
        print(json.dumps(run), flush=True)
        runs.append(run)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in runs))
    names = [r["name"] for r in runs[0]["rows"]]
    for run in runs[1:]:
        names += [r["name"] for r in run["rows"] if r["name"] not in names]
    print(f"{'conv':18s}" + "".join(f" | run {i} ms, host us" for i in range(len(runs))))
    for name in names:
        cells = []
        for run in runs:
            row = next((r for r in run["rows"] if r["name"] == name), None)
            cells.append("-" if row is None else f"{row['ms']:.4f}, {row['host_us']:.1f}")
        print(f"{name:18s}" + "".join(f" | {c:18s}" for c in cells))
    print(f"{'per forward':18s}" + "".join(
        f" | {r['forward_ms']:.4f}, {r['forward_host_us']:.1f}" for r in runs))
    print("encode us: " + ", ".join(str(r["encode_us"]) for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
