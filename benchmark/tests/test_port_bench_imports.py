"""What the benchmark loads: no module of JAX or of the JAX package (top-level names
compared whole, since the port's ``blindno_torch`` begins with ``blindno``), and, for
the reference, nothing of the port either."""
from __future__ import annotations

import json
import subprocess
import sys

from benchmark import common, run

PROBE = """
import json, sys, tempfile
import torch
torch.set_num_threads(1)
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_whole():
    assert "blindno_torch" not in set(run.FORBIDDEN)
    assert {"jax", "jaxlib", "flax", "blindno"} <= set(run.FORBIDDEN)


def test_reference_loads_no_program():
    names = _loaded("import benchmark.reference.models, benchmark.reference.train, "
                    "benchmark.check, benchmark.kernel_bounds")
    assert not names & {"jax", "jaxlib", "flax", "blindno", "blindno_torch"}


def test_cells_load_no_jax():
    """A small run of every cell on the CPU, its readers included."""
    body = """
from benchmark import common, run
from benchmark.tests.conftest import small_run
spec = common.benchmark_spec()
for cell in [w["name"] for w in spec["workloads"]]:
    with tempfile.TemporaryDirectory() as tmp:
        r = small_run(cell, tmp)
        r.trace = True
        run.execute(r, spec)
"""
    names = _loaded(body)
    assert "blindno_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "blindno"}
