"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names, and the references import nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from vvbench.harness import forbidden_modules
from vvbench.tests.toy import REPO


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["videovector_tpu_torch",
                              "videovector_tpu_torch.ops", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["videovector_tpu.ops.pallas"]) == [
        "videovector_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax(tmp_path):
    """The harness, its drivers and the port's modules they reach, imported
    in a fresh process: none of the forbidden modules is loaded."""
    code = (
        "import sys\n"
        "from vvbench import run, control, spec\n"
        "from vvbench.harness import forbidden_modules\n"
        "from pathlib import Path\n"
        "root = Path.cwd()\n"
        "for wl in spec.load_bench(root)['workloads']:\n"
        "    spec.cell(root, wl['name']).driver()\n"
        "import videovector_tpu_torch.models.retrieval_pipeline\n"
        "import videovector_tpu_torch.solver.driver\n"
        "import videovector_tpu_torch.data.native\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_references_import_nothing_of_the_program():
    for path in sorted((REPO / "vvbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top in ("__future__", "contextlib", "numpy", "torch",
                               "vvbench"), (path.name, name)
                assert not name.startswith("vvbench.") or name.startswith(
                    "vvbench.reference"), (path.name, name)
