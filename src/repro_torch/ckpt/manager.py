"""Fault-tolerant checkpointing: atomic, async, auto-resume, keep policy.

The port of ``repro/ckpt/manager.py``, with its design and its format, so
a checkpoint written by either package restores in the other:

  * **format**: one ``arrays.npz`` keyed by the reference's tree paths
    (``params/layers/attn/wq``, ``opt/m/layers/moe/gate``, ``opt/step``,
    ...: the layers stacked on a leading L axis, as the reference holds
    them; :func:`repro_torch.models.convert.to_reference`) and a
    ``manifest.json`` of the step and the sorted keys.  bf16 leaves are
    their raw bits as ``|V2``, which is what ``np.savez`` writes for the
    reference's bf16 arrays, and they restore as bf16 (the reference's
    own restore cannot cast them back);
  * **atomic**: state is written to ``step_<n>.tmp/`` then ``os.replace``d
    to ``step_<n>/``, so a preempted writer never corrupts the latest
    checkpoint; stale ``.tmp`` dirs are removed when a manager starts;
  * **async**: ``save()`` copies the state to host numpy arrays (blocking
    only on the copy), then serializes on a background thread so the
    train loop resumes; ``wait()`` joins the write in flight;
  * **auto-resume**: ``latest_step()`` / ``restore()`` pick the newest
    complete checkpoint and load it into a train state in place;
  * **keep policy**: the newest ``keep`` checkpoints are retained.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models import convert


def reference_tree(state) -> dict:
    """A train state (``{"model", "opt": {master, m, v, step}}``, and any
    slot a gradient hook added) as the reference's tree of numpy arrays:
    ``params`` for the model, each slot keyed by parameter name stacked
    as the parameters are."""
    model = state["model"]

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return convert.to_numpy(v)
        return convert.to_reference(model.cfg, v)

    tree = {"params": convert.to_reference(model.cfg, model)}
    for key, val in state.items():
        if key == "opt":
            tree[key] = {k: leaf(v) for k, v in val.items()}
        elif key != "model":
            tree[key] = leaf(val)
    return tree


def load_reference_tree(state, tree) -> None:
    """Copy a reference tree into a train state in place, each leaf cast
    to its tensor's dtype (bf16 from its ``|V2`` bits)."""
    model = state["model"]

    def load(dst, src):
        if isinstance(dst, torch.Tensor):
            with torch.no_grad():
                dst.copy_(convert.to_torch(src))
        else:
            convert.load_tree(model.cfg, dst, src, cast=True)

    convert.load_tree(model.cfg, dict(model.named_parameters()),
                      tree["params"], cast=True)
    for key, val in state.items():
        if key == "opt":
            for k, v in val.items():
                load(v, tree[key][k])
        elif key != "model":
            load(val, tree[key])


def _flatten(tree, prefix=""):
    """``{"a/b/c": leaf}`` over a nested dict, keys sorted at every level
    (the order of the reference's ``tree_flatten_with_path``)."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _unflatten(keyed) -> dict:
    tree = {}
    for key, val in keyed.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = val
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)
        # remove the interrupted writes of a previous incarnation
        for d in os.listdir(directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state, blocking: bool = False):
        host = _flatten(reference_tree(state))             # device -> host
        self.wait()

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "keys": sorted(host)}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like):
        """Load checkpoint ``step`` into the train state ``like`` in place
        (each leaf cast to its tensor's dtype) and return it."""
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        with np.load(path) as arrays:
            tree = _unflatten({k: arrays[k] for k in arrays.files})
        load_reference_tree(like, tree)
        return like
