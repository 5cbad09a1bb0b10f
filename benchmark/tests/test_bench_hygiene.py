"""Nothing that a run imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``dct_tpu`` (compared whole: the port's name begins with the
JAX package's), the reference imports nothing of the port, and a run
without a card exits non-zero and prints no result."""
from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.run import BENCH, ROOT

PROBE = """
import sys
from benchmark import run, calibrate
from benchmark.run import load_module, spec_of, BENCH
spec = spec_of()
for path in sorted((BENCH / "drivers").glob("*.py")):
    load_module(path)
for m in spec["end_to_end"] + spec["per_layer"]:
    load_module(BENCH / "metrics" / (m["name"] + ".py"))
import dct_tpu_torch.train.steps, dct_tpu_torch.train.city, dct_tpu_torch.models
import dct_tpu_torch.data.city_augment, dct_tpu_torch.losses
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_no_jax_in_a_run():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split()
    assert "dct_tpu_torch" in out
    assert not {"jax", "jaxlib", "flax", "dct_tpu"} & set(out)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".", 1)[0] in {"torch", "numpy", "typing", "__future__",
                                              "math"}, (path, n)
    probe = ("import sys; import benchmark.reference.train, benchmark.reference.nets; "
             "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert "dct_tpu_torch" not in out and "dct_tpu" not in out and "jax" not in out


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "enet-acdc-cotrain-b64", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
