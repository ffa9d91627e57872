"""The lower-precision control of a serving cell whose program has no int8
path (TransUNet): the plain reference with every conv and matmul rounded to
float8 e4m3 (``quant="fp8"``), served in the program's place through the
cell's own driver, and judged by its comparison against the f32 reference.

    python3 portbench/control_fp8.py --workload <name> --seeds 101 102 103 --seconds 2

For each seed, one run of the cell with a short window (the cell's own
load and sizes) prints a JSON line of every reading its check compares,
and whether the run came out correct.  ``control.py``'s serving control is
the program's int8 ``Predictor``, which such a model refuses.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from portbench import harness  # noqa: E402


class Fp8Reference(nn.Module):
    """The plain reference of a configuration in fp8, as a model the
    ``Predictor`` serves: NHWC f32 images in, f32 NHWC logits out."""

    hw_divisor, compute_dtype, name = 16, None, "fp8_reference"

    def __init__(self, state_dict: dict, cfg: dict, ref):
        super().__init__()
        self.sd, self.cfg, self.ref = state_dict, cfg, ref

    def __deepcopy__(self, memo):
        # the serving copy: the weights are only read, so it shares them
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with self.ref.no_tf32():
            return self.ref.forward(self.sd, self.cfg, x, quant="fp8")


def served_in_fp8(spec: harness.Spec, state_dict: dict, device) -> Fp8Reference:
    """``harness.port_model``'s stand-in: the reference in fp8 on the weights."""
    return Fp8Reference(state_dict, spec.config, harness.reference(spec))


def execute(spec: harness.Spec, seed: int, seconds: float, device) -> harness.Run:
    """One run of the serving cell with the fp8 reference in the program's place."""
    port_model = harness.port_model
    harness.port_model = served_in_fp8
    try:
        return harness.execute(spec, seed, seconds, False, device)
    finally:
        harness.port_model = port_model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        print("control_fp8: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.cell_spec(args.workload)
    if spec.traffic["driver"] != "serve_closed":
        print("control_fp8: a serving cell only", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        run = execute(spec, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "mode": "fp8_reference", "seed": seed,
                          "correct": run.correct, "readings": run.readings,
                          "checks": run.checks, "notes": run.notes,
                          "seconds": time.perf_counter() - t}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
