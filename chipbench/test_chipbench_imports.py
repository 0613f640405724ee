"""What a run loads, in a fresh process: the references alone load nothing
of the program, and a smoke run of the program with the check after it
loads no module whose top-level name (before the first dot, compared
whole) is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package the
port was made from)."""

import json
import subprocess
import sys

import pytest

from chipbench import harness

CODE = """
import json, sys
sys.path.insert(0, {root!r})
import importlib, pathlib
import torch
torch.set_num_threads(1)
for f in sorted(pathlib.Path({root!r}, "chipbench", "reference").glob("*.py")):
    importlib.import_module("chipbench.reference." + f.stem)
ref_tops = sorted({{m.split(".")[0] for m in sys.modules}})
import chipbench.run
from chipbench import harness, smoke, train
harness.boot()
cell = smoke.smoke_cell("minicpm-2b-deq.train-8x1k")
rec = train.run_program(cell, 5, 0.0, False, torch.device("cpu"))
train.check(cell, 5, rec, torch.device("cpu"))
run_tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"reference": ref_tops, "run": run_tops}}))
"""


@pytest.fixture(scope="module")
def loaded():
    out = subprocess.run([sys.executable, "-c",
                          CODE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(loaded):
    assert "repro_torch" in loaded["run"]
    assert not set(loaded["run"]) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program(loaded):
    assert not set(loaded["reference"]) & (set(harness.FORBIDDEN)
                                           | {"repro_torch"})
