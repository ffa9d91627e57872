"""Readings that the correctness limits are set from, on the card.

    python3 portbench/control.py --workload <name> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--fault-seeds 201 202 203] --seconds 2

For each seed, one run of the cell with a short window (the cell's own load
and sizes) prints a JSON line of every reading its check can compare: the program as the
benchmark runs it (``program``), the control in its place (``control``: the
program's int8 serving for a serving cell, the reference's step in float8
for a training cell), and, for a training cell, the program with half of
each batch left out (``fault_half_batch``, the mean taken over the rest).
All in one process, so the port's kernels build once.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def _half_batch():
    """Patch ``TrainStep.__call__`` to step on the first half of each batch."""
    from unet_medical_image_contour_segmentation_torch.engine.train import TrainStep

    call = TrainStep.__call__

    def half(self, batch, lr):
        return call(self, {k: v[:len(v) // 2] for k, v in batch.items()}, lr)

    TrainStep.__call__ = half
    return lambda: setattr(TrainStep, "__call__", call)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.cell_spec(args.workload)
    plan = ([("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
            + [("fault_half_batch", s) for s in args.fault_seeds])
    for mode, seed in plan:
        undo = _half_batch() if mode == "fault_half_batch" else None
        t = time.perf_counter()
        try:
            run = harness.execute(spec, seed, args.seconds, False, device,
                                  control=mode == "control")
        finally:
            if undo:
                undo()
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                          "readings": run.readings,
                          "notes": run.notes,
                          "details": run.details,
                          "seconds": time.perf_counter() - t}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
