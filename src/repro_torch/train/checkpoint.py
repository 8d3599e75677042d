"""Fault-tolerant checkpointing: atomic, async, retention, manifest.

Port of `repro.train.checkpoint`, with the same layout on disk (one
directory per step):

    <root>/step_00001200/
        arrays.npz        every leaf as host numpy, under the reference's
                          leaf names (`utils.tree.tree_flatten_with_names`:
                          the port's per-layer lists stacked as the
                          reference stacks them)
        manifest.json     step, leaf names/shapes/dtypes, user metadata
    <root>/LATEST          text file -> "step_00001200"  (atomic pointer)

so either package restores the other's checkpoints.  bfloat16 leaves are
stored as their uint16 bits with "bfloat16" as their manifest dtype:
numpy has no bfloat16 of its own, and the machines the port runs on need
not have `ml_dtypes` (a bfloat16 array the reference wrote loads back as
2-byte void or `ml_dtypes` data and is read as the same bits).

Crash-safety: the step directory is written under a `tmp.` prefix and
renamed into place (rename is atomic on POSIX); LATEST is updated last,
also via rename.  A crash mid-save leaves only a tmp dir that the next
`CheckpointManager` sweeps away: never a half checkpoint that restore
could pick up.

Async: `save()` snapshots the tensors to host memory, then hands the
file I/O to a background thread; `wait()` joins it.  Retention keeps the
newest `keep` checkpoints plus every multiple of `keep_period`
(milestones).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import (named_groups, stack_parts,
                                    tree_unflatten_with_names)

log = get_logger("checkpoint")

_STEP_RE = re.compile(r"^step_(\d{8})$")
BF16 = "bfloat16"


def _step_dirname(step: int) -> str:
    return f"step_{step:08d}"


def _host(x) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype) of one leaf; bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy(), BF16
        a = x.numpy()
    else:     # a number: the step, int32 as the reference stores it
        a = np.asarray(x, np.int32 if isinstance(x, int) else None)
    return a, str(a.dtype)


def _stacked_host(parts, lead) -> tuple[np.ndarray, str]:
    """One leaf's parts stacked where they lie (on the card: one copy to
    the host per leaf, no host-side stacking), then on the host."""
    if isinstance(parts[0], torch.Tensor):
        parts = [p.detach() for p in parts]
    return _host(stack_parts(parts, lead))


def _to_tensor(a: np.ndarray, dtype: str, ref, device):
    """A checkpoint array as a leaf like `ref` (a tensor: its dtype, on
    `device` or its own; a number or array: as numpy)."""
    if dtype == BF16 or a.dtype.name == BF16 or (
            a.dtype.kind == "V" and a.dtype.itemsize == 2):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if not isinstance(ref, torch.Tensor):
        return type(ref)(t.item()) if isinstance(ref, (int, float)) \
            else t.numpy()
    dev = device if device is not None else ref.device
    return t.to(dtype=ref.dtype, device=dev)


@dataclass
class CheckpointManager:
    root: str
    keep: int = 3
    keep_period: int = 0              # 0 = no milestones
    async_save: bool = True
    _thread: threading.Thread | None = field(default=None, repr=False)
    _error: BaseException | None = field(default=None, repr=False)

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._gc_tmp()

    # ------------------------------------------------------------- save

    def save(self, state, step: int | None = None, metadata: dict | None = None):
        """Snapshot `state` (any tree; TrainState works) and persist it."""
        self.wait()
        if step is None:
            step = int(state.step)
        # snapshot to host NOW (the step goes on updating in place); the
        # file I/O can be async
        host, dtypes = {}, {}
        for name, parts, lead in named_groups(state):
            host[name], dtypes[name] = _stacked_host(parts, lead)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "leaves": {
                name: {"shape": list(a.shape), "dtype": dtypes[name]}
                for name, a in host.items()
            },
            "metadata": metadata or {},
        }
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(int(step), host, manifest),
                daemon=True)
            self._thread.start()
        else:
            self._write(int(step), host, manifest)

    def _write(self, step: int, host: dict, manifest: dict):
        final = os.path.join(self.root, _step_dirname(step))
        tmp = os.path.join(self.root, f"tmp.{_step_dirname(step)}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic commit
            self._point_latest(step)
            self._retain()
            log.info("saved checkpoint step=%d -> %s", step, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _write_async(self, step: int, host: dict, manifest: dict):
        try:
            self._write(step, host, manifest)
        except BaseException as e:       # re-raised by wait()
            self._error = e

    def _point_latest(self, step: int):
        tmp = os.path.join(self.root, f"LATEST.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(_step_dirname(step))
        os.rename(tmp, os.path.join(self.root, "LATEST"))

    def wait(self):
        """Join the pending async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        latest = os.path.join(self.root, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                m = _STEP_RE.match(f.read().strip())
            if m:
                step = int(m.group(1))
                if step in self.all_steps():
                    return step
        steps = self.all_steps()                  # pointer lost: fall back
        return steps[-1] if steps else None

    def restore_arrays(self, step: int | None = None) -> tuple[dict, dict]:
        """-> ({leaf name: np.ndarray}, manifest).  Raw host-side load
        (bf16 leaves as their uint16 bits)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, _step_dirname(step))
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        path = os.path.join(d, "arrays.npz")
        with np.load(path) as z:
            names = list(z.files)

        def read(name):        # a handle of its own per member
            with np.load(path) as z:
                return name, z[name]
        # the members' reads and CRC checks release the interpreter lock,
        # so threads overlap them
        with ThreadPoolExecutor(max_workers=min(8, max(1, len(names)))) as ex:
            arrays = dict(ex.map(read, names))
        return arrays, manifest

    def restore(self, like, step: int | None = None, device=None):
        """Restore into the structure of `like` (a tree of tensors, e.g.
        `train_step.state_like(state)` on the "meta" device, or of
        numbers): every leaf in `like`'s dtype, on `device` (default:
        the leaf's own device).  Returns (tree, manifest)."""
        arrays, manifest = self.restore_arrays(step)
        dtypes = {n: v["dtype"] for n, v in manifest["leaves"].items()}
        tree = tree_unflatten_with_names(
            like, arrays, fn=lambda a, ref, name: _to_tensor(
                a, dtypes.get(name, str(a.dtype)), ref, device))
        return tree, manifest

    # --------------------------------------------------------- retention

    def _retain(self):
        steps = self.all_steps()
        if len(steps) <= self.keep:
            return
        protect = set(steps[-self.keep:])
        if self.keep_period:
            protect |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in protect:
                shutil.rmtree(os.path.join(self.root, _step_dirname(s)),
                              ignore_errors=True)

    def _gc_tmp(self):
        for name in os.listdir(self.root):
            if name.startswith("tmp.") or name.startswith("LATEST.tmp"):
                path = os.path.join(self.root, name)
                (shutil.rmtree if os.path.isdir(path) else os.remove)(path)
