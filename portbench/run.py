"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up (``setup_s``, from the start of this script to the first
timed call), measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line of
standard output; the numbers compared go to the last lines of standard
error too.  Exits non-zero without a result when there is no CUDA card or
fewer than the cell asks for, when the port cannot be imported, or when JAX
or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    harness.set_cache_dirs()
    spec = harness.cell_spec(args.workload)
    import torch

    chips = spec.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.execute(spec, args.seed, args.seconds, bool(args.trace), device, T_START)
    line = harness.result_line(run)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package got loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for key, value in run.notes.items():
        print(f"portbench: {key} {value}", file=sys.stderr)
    for key, value in run.readings.items():
        print(f"reading {key} {value!r}", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
