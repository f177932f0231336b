"""Checkpoint and resume for time- and load-stepping loops (port of
``iifea_tpu/utils/checkpoint.py``; the same files, so a checkpoint written
by either package resumes in the other).

The unsteady demos persist their full state (the background dof
vector(s), the step index and the time) and resume exactly. Format: one
``ckpt_<step>.npz`` per checkpoint with a ``.meta.json`` beside it and a
rolling ``latest`` file naming the newest; tensors are copied to the host
to be saved and restored onto the caller's device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def save_checkpoint(directory: str, step: int, state: dict,
                    meta: dict | None = None) -> str:
    """state: {name: tensor or array}; meta: small JSON-serialisable
    scalars (t, Dt, ...). Returns the .npz path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in state.items()}
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    latest = os.path.join(directory, "latest")
    tmp = latest + ".tmp"
    with open(tmp, "w") as f:
        f.write(os.path.basename(path))
    os.replace(tmp, latest)
    return path


def load_checkpoint(directory: str, step: int | None = None, *,
                    device="cuda"):
    """(step, {name: tensor on ``device``}, meta dict) of the newest
    checkpoint (or of ``step``), or None when there is none."""
    if step is None:
        latest = os.path.join(directory, "latest")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            path = os.path.join(directory, f.read().strip())
    else:
        path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        state = {k: torch.as_tensor(data[k], device=device)
                 for k in data.files}
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return meta.get("step", step or 0), state, meta
