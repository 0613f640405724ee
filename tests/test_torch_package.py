"""Package-level checks of the port (``repro_torch``).

  * Importing every module of the port pulls in neither JAX nor any module
    of the JAX package (checked in a fresh interpreter).
  * The port's own copies of the config schema and registry equal the JAX
    package's, field by field.
  * Entry points run on the card by default: with no CUDA and no device
    asked for they raise; with ``device="cpu"`` they run.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg
from repro_torch.models import lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), "modules;", "leaked:", bad)
assert not bad, bad
assert len(names) >= 25, names
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    assert "leaked: []" in out.stdout


@pytest.mark.parametrize("deq", [False, True])
@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_config_copies_equal_the_jax_package(make, deq):
    for name in treg.ARCHS:
        want = getattr(jreg, make)(name, deq=deq)
        got = getattr(treg, make)(name, deq=deq)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert (got.padded_vocab, got.head_dim_, got.attn_dim, got.kv_dim) \
            == (want.padded_vocab, want.head_dim_, want.attn_dim,
                want.kv_dim)
    assert set(treg.ARCHS) == {n for n, c in jreg.ARCHS.items()
                               if c.family == "dense"}


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    cfg = treg.smoke_config("minicpm-2b", deq=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 2, 8)
    params = lm.init_params(cfg, seed=0, device="cpu")
    assert params["embed"]["embedding"].device.type == "cpu"
    assert params["embed"]["embedding"].shape == (cfg.padded_vocab,
                                                  cfg.d_model)
