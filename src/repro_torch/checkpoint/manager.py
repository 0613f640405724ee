"""Checkpoints: atomic, asynchronous, verified on restore.

The port of ``repro/checkpoint/manager.py``.  Layout: ``<dir>/step_<N>/
{manifest.json, arrays.npz}``, written as ``step_<N>.tmp`` and renamed when
complete, so a crashed save never shadows the latest good checkpoint.
``save`` copies the state to the host, then hands the file write to a
thread; the next save (or ``wait``) joins it.

Leaves are keyed by their path in the state, spelled as the JAX package
spells it (``.params['embed']['embedding']``, ``.carry.lowrank.u``), so
``omit_prefixes`` and ``fill_missing_prefixes`` name the same leaves in
both packages.  npz has no bfloat16: bf16 leaves are stored as f32
(lossless) and cast back to the template's dtype on restore.

A sharded state (DTensor leaves) is saved as whole leaves: every rank
calls ``save`` (the gather is a collective) and rank 0 writes.  ``restore`` places each leaf as its template
leaf lies, or by ``shardings`` (a spec tree) on ``device_mesh``, so a
state written on one mesh restores onto any other.  On a process group,
``restore`` and ``latest_step`` first wait until the writer is done.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.obs import metrics as obs_metrics

Tree = Any


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint directory failed verification on restore (unreadable
    or unparseable manifest, unloadable arrays, or stored keys that do not
    match the manifest)."""


def map_with_path(fn: Callable[[str, Any], Any], tree: Tree,
                  path: str = "") -> Tree:
    """Rebuild ``tree`` (NamedTuples, dataclasses, dicts) with every
    non-None leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          f"{path}.{f}")
                            for f in tree._fields))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name),
                                  f"{path}.{f.name}")
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def _flatten(tree: Tree) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}

    def put(path, leaf):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = torch.as_tensor(leaf).detach()
        dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        # always a copy: ``.cpu()`` of a CPU tensor is the tensor itself and
        # ``.numpy()`` shares its memory, and the train step updates the
        # state in place while the writer thread runs
        flat[path] = t.to("cpu", dt, copy=True).numpy()

    map_with_path(put, tree)
    return flat


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True,
                 omit_prefixes: tuple[str, ...] = ()):
        """``omit_prefixes``: checkpoint-lean mode, leaves whose key path
        starts with one of these are not written (e.g. the
        ``.carry.lowrank.u``/``.v`` ring); restore them with a matching
        ``fill_missing_prefixes``.  Bytes left out land in the
        ``checkpoint_bytes_omitted`` counter.  Rank 0 of a process group
        (or the one process without one) writes."""
        self.dir = directory
        self.writer = not dist.is_initialized() or dist.get_rank() == 0
        self.keep = keep
        self.async_save = async_save
        self.omit_prefixes = tuple(omit_prefixes)
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Tree, extra: dict | None = None) -> None:
        self.wait()
        arrays = _flatten(state)
        omitted_bytes = 0
        if self.omit_prefixes:
            omit = {k for k in arrays
                    if any(k.startswith(p) for p in self.omit_prefixes)}
            omitted_bytes = sum(arrays[k].nbytes for k in omit)
            arrays = {k: v for k, v in arrays.items() if k not in omit}
            reg = obs_metrics.default_registry()
            reg.counter("checkpoint_bytes_omitted").inc(omitted_bytes)
            reg.counter("checkpoint_leaves_omitted").inc(len(omit))
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(arrays),
            "omitted": {"prefixes": list(self.omit_prefixes),
                        "bytes": omitted_bytes},
            "extra": extra or {},
        }

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if not self.writer:
            return
        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()

    def _sync(self) -> None:
        """The writer's save finished, seen by every rank."""
        self.wait()
        if dist.is_initialized():
            dist.barrier()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        self._sync()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_step(self, step: int) -> tuple[dict, dict[str, np.ndarray]]:
        """Read and verify one checkpoint: the manifest parses, every array
        decompresses, and the stored keys are the manifest's."""
        base = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(base, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(base, "arrays.npz")) as data:
                arrays = {k: data[k] for k in data.files}  # full reads
        except Exception as e:
            raise CheckpointCorruptionError(
                f"checkpoint step_{step} unreadable: {e!r}") from e
        if sorted(arrays) != list(manifest.get("keys", [])):
            raise CheckpointCorruptionError(
                f"checkpoint step_{step} corrupt: stored arrays do not match "
                f"the manifest key list ({len(arrays)} stored vs "
                f"{len(manifest.get('keys', []))} declared)")
        return manifest, arrays

    def restore(self, template: Tree, step: int | None = None,
                fill_missing_prefixes: tuple[str, ...] = (),
                shardings: Tree | None = None, device_mesh=None
                ) -> tuple[int, Tree, dict]:
        """Restore into the structure of ``template``; each leaf takes the
        template leaf's dtype and device.

        ``fill_missing_prefixes``: template leaves under these key prefixes
        may be absent from the checkpoint and are zero-filled (state the
        writer did not have, such as a lean checkpoint's ring).  Any other
        missing key raises.  With ``step=None`` a corrupt latest checkpoint
        falls back, loudly, to the previous intact one (counted in
        ``checkpoint_corruptions_total``); an explicit ``step`` raises
        :class:`CheckpointCorruptionError`.

        A DTensor template leaf is restored with its own placements;
        ``shardings`` (a spec tree shaped as ``template``) with
        ``device_mesh`` places the leaves instead."""
        self._sync()
        specs = {}
        if shardings is not None:
            map_with_path(lambda p, sp: specs.__setitem__(p, sp), shardings)
        if step is None and not self.all_steps():
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        if step is not None:
            manifest, data = self._read_step(step)
        else:
            manifest = data = None
            candidates = sorted(self.all_steps(), reverse=True)
            for s in candidates:
                try:
                    manifest, data = self._read_step(s)
                    step = s
                    break
                except CheckpointCorruptionError as e:
                    obs_metrics.default_registry().counter(
                        "checkpoint_corruptions_total").inc()
                    print(f"checkpoint restore: {e} -- falling back to the "
                          f"previous checkpoint")
            if data is None:
                raise CheckpointCorruptionError(
                    f"every checkpoint under {self.dir} failed verification "
                    f"({candidates})")

        filled = []

        def load(path, tmpl):
            tmpl = tmpl if isinstance(tmpl, DTensor) else \
                torch.as_tensor(tmpl)
            if path not in data and any(
                    path.startswith(p) for p in fill_missing_prefixes):
                filled.append(path)
                return _place(torch.zeros(tmpl.shape, dtype=tmpl.dtype,
                                          device=tmpl.device), tmpl, path)
            arr = data[path]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch at {path}: {arr.shape} vs "
                                 f"{tuple(tmpl.shape)}")
            return _place(torch.from_numpy(np.array(arr)).to(
                device=tmpl.device, dtype=tmpl.dtype), tmpl, path)

        def _place(whole, tmpl, path):
            if path in specs and specs[path] is not None:
                from repro_torch.parallel.sharding import placements
                return distribute_tensor(whole, device_mesh,
                                         placements(specs[path], device_mesh),
                                         src_data_rank=None)
            if isinstance(tmpl, DTensor):
                return distribute_tensor(whole, tmpl.device_mesh,
                                         tmpl.placements, src_data_rank=None)
            return whole

        state = map_with_path(load, template)
        if filled:
            print(f"checkpoint restore: zero-filled {len(filled)} leaves "
                  f"missing from step_{step} ({filled[0]} ...)")
        return step, state, manifest["extra"]
