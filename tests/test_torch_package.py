"""Package-level checks of the port (``repro_torch``).

  * Importing every module of the port pulls in neither JAX nor any module
    of the JAX package (checked in a fresh interpreter).
  * The port's own copies of the config schema and registry (all ten
    configs, in the reference's order), and of the trainer's
    ``TrainConfig``, equal the JAX package's, field by field.
  * Entry points run on the card by default: with no CUDA and no device
    asked for they raise; with ``device="cpu"`` they run.
"""

import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import train as train_launcher
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
assert len(names) >= 35, names
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
    assert set(treg.ARCHS) == set(jreg.ARCHS)
    assert list(treg.ARCHS) == list(jreg.ARCHS)


@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_zamba2_config_copy_equals_the_jax_package(make):
    want = getattr(jreg, make)("zamba2-2.7b")
    got = getattr(treg, make)("zamba2-2.7b")
    assert _fields(type(got.ssm)) == _fields(type(want.ssm))
    assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == "hybrid"
    if make == "get_config":  # the published widths and depth
        assert (got.num_layers, got.d_model, got.head_dim_, got.ssm.chunk,
                got.ssm.attn_every) == (54, 2560, 80, 256, 6)
    else:  # two units of three, the reference's smoke cut
        assert (got.num_layers, got.ssm.d_state, got.ssm.head_dim,
                got.ssm.chunk, got.ssm.attn_every) == (6, 16, 16, 16, 3)


@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_xlstm_config_copy_equals_the_jax_package(make):
    assert _fields(tbase.XLSTMConfig) == _fields(jbase.XLSTMConfig)
    assert dataclasses.asdict(tbase.XLSTMConfig()) == \
        dataclasses.asdict(jbase.XLSTMConfig())
    want = getattr(jreg, make)("xlstm-1.3b")
    got = getattr(treg, make)("xlstm-1.3b")
    assert dataclasses.asdict(got.xlstm) == dataclasses.asdict(want.xlstm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == "ssm" and got.d_ff == 0
    if make == "get_config":  # the published widths and depth
        assert (got.num_layers, got.d_model, got.xlstm.slstm_every,
                got.xlstm.chunk) == (48, 2048, 8, 256)
        assert (got.num_heads, got.vocab_size, got.xlstm.mlstm_proj_factor,
                got.xlstm.slstm_proj_factor) == (4, 50304, 2.0, 4.0 / 3.0)
    else:  # two units of four, the reference's smoke cut
        assert (got.num_layers, got.xlstm.slstm_every,
                got.xlstm.chunk) == (8, 4, 16)


def test_train_config_copy_equals_the_jax_package():
    got, want = tbase.TrainConfig(), jbase.TrainConfig()
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
        [(f.name, f.type) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.deq_carry, got.skip_nonfinite, got.skip_budget, got.z_loss,
            got.warmup_steps) == ("state", True, 5, 1e-4, 10)


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    cfg = treg.smoke_config("minicpm-2b", deq=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launcher.main(["--smoke", "--deq", "--steps", "1"])
    params = lm.init_params(cfg, seed=0, device="cpu")
    assert params["embed"]["embedding"].device.type == "cpu"
    assert params["embed"]["embedding"].shape == (cfg.padded_vocab,
                                                  cfg.d_model)


NEW_MODULES = ("runtime/faultinject.py", "core/bilevel.py", "core/deq.py",
               "core/hypergrad.py", "models/mdeq.py", "configs/mdeq_cifar.py",
               "models/ssm.py", "configs/zamba2_2p7b.py", "models/lm.py",
               "launch/train.py", "models/xlstm.py", "configs/xlstm_1p3b.py",
               "optim/optimizers.py", "launch/steps.py",
               "kernels/flash_xla.py", "configs/hubert_xlarge.py",
               "configs/pixtral_12b.py", "data/pipeline.py",
               "parallel/__init__.py", "parallel/sharding.py",
               "launch/mesh.py", "configs/shapes.py", "launch/dryrun.py",
               "configs/base.py", "models/layers.py", "kernels/ops.py",
               "core/solvers.py", "device.py", "optim/compression.py",
               "runtime/ft.py", "runtime/trainer.py", "runtime/serving.py",
               "checkpoint/manager.py", "models/moe.py",
               "models/attention.py", "implicit/fixed_point.py",
               "implicit/engine.py", "launch/serve.py")


@pytest.mark.parametrize("path", NEW_MODULES)
def test_fault_bilevel_and_mdeq_modules_import_neither_jax_nor_repro(path):
    src = open(os.path.join(REPO, "src", "repro_torch", path)).read()
    assert not re.search(r"^\s*(import|from) (jax|repro)\b", src, re.M), path


def _fields(cls) -> list:
    return [(f.name, str(f.type)) for f in dataclasses.fields(cls)]


def test_layout_classes_equal_the_jax_package():
    """The layout slice's dataclasses, field by field, and the struct
    helpers' names, against the reference's."""
    from repro.configs import shapes as jshapes
    from repro.launch import steps as jsteps
    from repro.parallel import sharding as jsh
    from repro_torch.configs import shapes as tshapes
    from repro_torch.launch import steps as tsteps
    from repro_torch.parallel import sharding as tsh
    assert _fields(tshapes.ShapeSuite) == _fields(jshapes.ShapeSuite)
    assert [f.name for f in dataclasses.fields(tsh.ShardingRules)] == \
        [f.name for f in dataclasses.fields(jsh.ShardingRules)]
    # the port's context carries the run's DeviceMesh beside the mesh
    # description (the reference's Mesh is both)
    assert [f.name for f in dataclasses.fields(tsh.ShardCtx)] == \
        [f.name for f in dataclasses.fields(jsh.ShardCtx)] + ["device_mesh"]
    assert [f.name for f in dataclasses.fields(lm.ParamDecl)][:2] == \
        [f.name for f in dataclasses.fields(jsh.ParamDecl)][:2]
    for name in ("param_shardings", "param_structs", "carry_shardings",
                 "state_shardings", "train_state_structs"):
        assert callable(getattr(tsteps, name)) and hasattr(jsteps, name)
    assert tbase.ModelConfig().num_params() == \
        jbase.ModelConfig().num_params()


@pytest.mark.parametrize("pair", ["mdeq", "hoag", "deq", "hypergrad"])
def test_paper_workload_configs_equal_the_jax_package(pair):
    from repro.configs import mdeq_cifar as jmdeq
    from repro.core import bilevel as jbil
    from repro.core import deq as jdeq
    from repro.core import hypergrad as jhyp
    from repro_torch.configs import mdeq_cifar as tmdeq
    from repro_torch.core import bilevel as tbil
    from repro_torch.core import deq as tdeq
    from repro_torch.core import hypergrad as thyp
    want, got = {"mdeq": (jmdeq.MDEQConfig, tmdeq.MDEQConfig),
                 "hoag": (jbil.HOAGConfig, tbil.HOAGConfig),
                 "deq": (jdeq.DEQConfig, tdeq.DEQConfig),
                 "hypergrad": (jhyp.BackwardConfig, thyp.BackwardConfig),
                 }[pair]
    assert _fields(got) == _fields(want)
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    if pair == "mdeq":
        assert tmdeq.CONFIG == tmdeq.MDEQConfig()
    if pair == "hoag":
        # the nested inner SolverConfig, field by field
        assert _fields(type(got().inner)) == _fields(type(want().inner))
    if hasattr(want(), "to_implicit"):
        assert dataclasses.asdict(got().to_implicit()) == \
            dataclasses.asdict(want().to_implicit())


def test_chip_smoke_alone_fails(tmp_path):
    """``chip_smoke.py`` copied into a directory that holds nothing else of
    the repository exits non-zero and prints no result line (it needs the
    checkout's ``src/``); the same holds wherever there is no card."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "repro_torch" in out.stderr
