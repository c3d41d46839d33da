"""Atomic, async checkpoints with auto-resume — the JAX package's
``repro.checkpoint.checkpoint`` on the port's trees, in the same layout:

    <dir>/step_<N>.tmp/...   (written)
    <dir>/step_<N>/          (renamed on completion: the atomic commit)
        manifest.json        {step, leaves, paths, dtypes, extra}
        leaf_00000.npy ...

One ``.npy`` file per leaf, leaves in ``jax.tree`` order
(:mod:`repro_torch.core.tree`: dict keys sorted).  numpy has no bf16, so a
bf16 leaf is saved as its ``uint16`` bits and the manifest keeps its
dtype.  ``save(..., async_save=True)`` copies the leaves to the host, then
writes them on one background thread; ``wait()`` joins it (and raises
what it raised), and the next ``save`` waits first, so at most one
checkpoint is in flight and a crash never leaves a committed step
half-written.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree

_MANIFEST = "manifest.json"


def _to_host(t: torch.Tensor) -> np.ndarray:
    # a copy even of a host tensor: an async save writes from it while
    # a donated step updates the state in place
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(like.device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, suffix: str = "") -> str:
        return os.path.join(self.dir, f"step_{step:08d}{suffix}")

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None,
             async_save: bool = False) -> None:
        self.wait()
        flat = list(tree.flatten_with_paths(state))
        host = [_to_host(leaf) for _, leaf in flat]
        manifest = {"step": step,
                    "leaves": [f"leaf_{i:05d}.npy" for i in range(len(flat))],
                    "paths": [p for p, _ in flat],
                    "dtypes": [str(leaf.dtype).removeprefix("torch.")
                               for _, leaf in flat],
                    "extra": extra or {}}

        def _write():
            tmp, final = self._path(step, ".tmp"), self._path(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for name, arr in zip(manifest["leaves"], host):
                np.save(os.path.join(tmp, name), arr)
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)              # atomic commit
            self._gc()

        if not async_save:
            _write()
            return

        def _run():
            try:
                _write()
            except Exception as e:             # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- read -------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name,
                                                    _MANIFEST)):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any,
                step: int | None = None) -> tuple[Any, int, dict]:
        """(tree shaped like ``like``, step, extra).  Each leaf takes the
        saved dtype and ``like``'s leaf's device; the saved leaf paths and
        shapes must match ``like``'s."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self._path(step)
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        flat = list(tree.flatten_with_paths(like))
        if [p for p, _ in flat] != manifest["paths"]:
            raise ValueError(f"checkpoint/model structure mismatch: step "
                             f"{step} holds {len(manifest['paths'])} leaves, "
                             f"the tree {len(flat)}")
        leaves = []
        for (p, leaf), name, dt in zip(flat, manifest["leaves"],
                                       manifest["dtypes"]):
            t = _from_host(np.load(os.path.join(path, name)), dt, leaf)
            if t.shape != leaf.shape:
                raise ValueError(f"checkpoint leaf {p}: shape "
                                 f"{tuple(t.shape)}, tree {tuple(leaf.shape)}")
            leaves.append(t)
        return tree.unflatten(like, leaves), step, manifest["extra"]
