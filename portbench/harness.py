"""The harness: find a cell's files by name, build what it runs, run its
driver, read its metrics and print the result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its
configuration is the file the manifest names; its traffic mix is
``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``;
the readings its check compares, each with its limit, are in
``workloads/<cell>.json``; each per-layer
metric is read by ``metrics/<metric>.py``, or where there is no such file by
``metrics/<stem>.py`` with the name's part before its first dot (one reader
for ``device_ms.serve`` and ``device_ms.train``); the plain reference of a
configuration is ``reference/<family>.py``.  Nothing here lists cells,
mixes or metrics: a new one is new files and manifest entries.  A data
file that sets a key nothing here reads is refused: a setting that is not
honoured would measure something other than what the file states.

:func:`execute` runs one cell once on a given device and returns the result
object; ``run.py`` calls it on the card, the tests on the CPU at small sizes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "unet_medical_image_contour_segmentation_tpu")
PORT = "unet_medical_image_contour_segmentation_torch"
# fixed cache directories inside the checkout, so that only a checkout's
# first run builds and compiles
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/portbench/triton",
              "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}

# the keys of a configuration file the harness, the drivers and the
# reference read; "name", "source", "reduced" and "assumed" document it
CONFIG_KEYS = {"name", "family", "model", "source", "widths", "n_channels", "n_classes",
               "bilinear", "compute_dtype", "parameters", "reduced", "assumed"}

__all__ = ["Run", "cell_spec", "execute", "forbidden_modules", "result_line"]


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


@dataclass
class Spec:
    """What a cell runs: its manifest entry, configuration, traffic mix and
    cell file, and the metrics it reports."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    slices: dict
    cell: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def unread_keys(data: dict, keys, prefix: str = "") -> List[str]:
    """The dotted names in ``data`` that ``keys`` does not cover (a key in
    ``keys`` covers its whole subtree)."""
    out = []
    for k, v in data.items():
        name = prefix + k
        if name in keys:
            continue
        out += unread_keys(v, keys, name + ".") if isinstance(v, dict) else [name]
    return out


def _refuse_unread(what: str, data: dict, keys) -> None:
    unread = unread_keys(data, keys)
    if unread:
        raise ValueError(f"{what} sets {', '.join(unread)}, which nothing reads")


def _for_cell(metrics: List[dict], name: str) -> List[dict]:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def cell_spec(name: str) -> Spec:
    """The :class:`Spec` of the cell ``name`` of ``BENCHMARK.json``."""
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    from portbench import traffic as inputs

    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    config = _json(ROOT / conf["file"])
    traffic = _json(BENCH / "traffic" / f"{entry['traffic']}.json")
    slices = _json(BENCH / "traffic" / f"{traffic['slices']}.json")
    _refuse_unread(conf["file"], config, CONFIG_KEYS)
    _refuse_unread(f"traffic/{entry['traffic']}.json", traffic,
                   importlib.import_module(f"portbench.drivers.{traffic['driver']}").KEYS)
    _refuse_unread(f"traffic/{traffic['slices']}.json", slices, inputs.SLICE_KEYS)
    return Spec(name, entry, config, traffic, slices,
                _json(BENCH / "workloads" / f"{name}.json"),
                _for_cell(m["end_to_end"], name), _for_cell(m["per_layer"], name))


@dataclass
class Run:
    """One run of a cell: its inputs, then what its driver measured."""
    spec: Spec
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False
    # filled by the cell's traffic driver
    t_window: Optional[float] = None        # perf_counter at the first timed call
    window_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    slices: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    profile: object = None
    memory_peak_bytes: int = 0
    readings: Dict[str, float] = field(default_factory=dict)   # numbers the check may compare
    checks: List[Tuple[str, float, Optional[float]]] = field(default_factory=list)
    notes: Dict[str, object] = field(default_factory=dict)
    details: Dict[str, object] = field(default_factory=dict)   # control.py prints these

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(lim is not None and math.isfinite(v) and v <= lim
                        for _, v, lim in self.checks))

    def stage(self, name: str) -> None:
        """Note the seconds since the process started at a set-up stage."""
        at = self.notes.setdefault("setup_stages", [])
        at.append(f"{name} {time.perf_counter() - self.t_start:.3f}")

    def compare(self) -> None:
        """Hold each reading that the cell file gives a limit against it; a
        reading the driver did not make is not correct."""
        self.checks = [(name, float(self.readings.get(name, math.nan)), limit)
                       for name, limit in self.spec.cell["limits"].items()]


def reference(spec: Spec):
    return importlib.import_module(f"portbench.reference.{spec.config['family']}")


def driver(spec: Spec):
    return importlib.import_module(f"portbench.drivers.{spec.traffic['driver']}")


def metric_file(name: str) -> Path:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<stem>.py`` with the part of the name before its first dot."""
    path = BENCH / "metrics" / f"{name}.py"
    return path if path.is_file() else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def metric_reader(name: str) -> Callable:
    path = metric_file(name)
    mod_spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def weights(run: Run, x) -> dict:
    """The seeded weights both sides get, in the reference's layout, with
    every BN's running statistics set on the f32 images ``x`` (the plain
    reference's ``calibrate_bn``).  The card's memory peak starts after them."""
    import torch

    from portbench import traffic

    ref = reference(run.spec)
    sd = ref.make_state_dict(run.spec.config, traffic.seeded(run.seed, 0, run.device), run.device)
    ref.calibrate_bn(sd, run.spec.config, x)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    return sd


def port_model(spec: Spec, state_dict: dict, device):
    """The port's model of the configuration, built on ``device`` with
    ``state_dict`` loaded (the port keeps the reference's layout)."""
    import torch

    from unet_medical_image_contour_segmentation_torch.models.unet import get_model

    cfg = spec.config
    with torch.device("meta"):
        model = get_model(cfg["model"], n_channels=cfg["n_channels"], n_classes=cfg["n_classes"],
                          bilinear=cfg["bilinear"],
                          compute_dtype=getattr(torch, cfg["compute_dtype"]))
    if list(model.widths) != list(cfg["widths"]):
        raise ValueError(f"{cfg['model']} has widths {model.widths}, the configuration "
                         f"{cfg['widths']}")
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def execute(spec: Spec, seed: int, seconds: float, trace: bool, device,
            t_start: Optional[float] = None, control: bool = False) -> Run:
    """Run the cell once on ``device`` and read its metrics (no card check)."""
    run = Run(spec, seed, seconds, trace, device,
              time.perf_counter() if t_start is None else t_start, control)
    driver(spec).run(run)
    run.end_to_end["setup_s"] = run.t_window - run.t_start
    run.compare()
    return run


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def result_line(run: Run) -> dict:
    """The result object: the cell's end-to-end metrics (``--trace 0``) or
    its per-layer ones (``--trace 1``) that have a reading, and the numbers
    compared, last."""
    import torch

    metrics = {}
    if run.trace:
        for m in run.spec.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.spec.end_to_end:
            if m["name"] not in run.end_to_end:
                raise RuntimeError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": run.spec.entry["chips"],
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit": _power_limit() if dev.type == "cuda" else None}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        out["breakdown"] = {"device_ops": [[n, s] for n, s in run.profile.device_ops],
                            "idle_gaps": [[n, s] for n, s in run.profile.idle_gaps]}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return out


def set_cache_dirs(root: Path = ROOT) -> None:
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(root / rel)
