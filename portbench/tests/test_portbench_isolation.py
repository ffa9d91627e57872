"""What the benchmark's processes load: never JAX or the JAX package; and
the reference, nothing of the port."""

import ast
import json
import subprocess
import sys

from portbench import harness

PORT = harness.PORT


def _in_fresh_process(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_path_loads_no_jax():
    code = f"""
import json, sys
sys.argv = ["run.py"]
import torch
import portbench.run
from portbench import harness
from portbench.tests.small import small_spec
for cell in [w["name"] for w in harness.manifest()["workloads"]]:
    run = harness.execute(small_spec(cell), 3, 0.2, True, torch.device("cpu"))
    harness.result_line(run)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"tops": tops, "forbidden": harness.forbidden_modules()}}))
"""
    got = _in_fresh_process(code)
    assert got["forbidden"] == []
    assert not set(got["tops"]) & set(harness.FORBIDDEN)
    assert PORT in got["tops"]  # the port itself is what the run drives


def test_reference_imports_nothing_of_the_port():
    for path in sorted((harness.BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            assert all(n.split(".")[0] not in (PORT, *harness.FORBIDDEN) for n in names), path
    got = _in_fresh_process("""
import json, sys
import portbench.reference.unet
print(json.dumps({"tops": sorted({m.split(".")[0] for m in sys.modules})}))
""")
    assert PORT not in got["tops"] and not set(got["tops"]) & set(harness.FORBIDDEN)


def test_names_compare_whole_top_level():
    # the port's name begins with the JAX package's stem: a prefix test would
    # take one for the other
    sys.modules.setdefault("unet_medical_image_contour_segmentation_tpux", sys)
    try:
        assert "unet_medical_image_contour_segmentation_tpux" not in harness.forbidden_modules()
    finally:
        del sys.modules["unet_medical_image_contour_segmentation_tpux"]


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "unet_s.serve_batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
