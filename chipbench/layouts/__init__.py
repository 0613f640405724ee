"""Model layouts, found by the ``layout`` key of a configuration file.

``chipbench/layouts/<layout>.py`` lays out the parameters as the program
takes them (``leaf_specs``), builds the program's configuration from the
file (``model_config``) and counts a training step's operations
(``train_step_flops``); the layout's plain reference is
``chipbench/reference/<layout>.py``.  A configuration of a new kind of
model adds these two files and edits none.
"""

from __future__ import annotations

import importlib
import re


def _module(package: str, cfg: dict):
    name = cfg["layout"]
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"bad layout name {name!r}")
    return importlib.import_module(f"{package}.{name}")


def layout(cfg: dict):
    return _module("chipbench.layouts", cfg)


def reference(cfg: dict):
    return _module("chipbench.reference", cfg)
