"""Chain checkpointing: save/resume with tuning parameters.

Host copy of ``mcmcdate_tpu/engine/checkpoint.py`` for torch state (that
module imports JAX).  The ``.mcmc.npz`` arrays, the ``.mcmc.json`` meta
(``FORMAT_VERSION``) and the trace sidecar are the same as the JAX
package's, so either package reads the other's files.  ``key`` is a
``uint32[2]`` array: a JAX PRNG key there, the port's RNG key here.

Replaces the reference engine's ``Save`` setting and
``mhgLoad``/``settingsLoad``/``mhgLoadUnsafe`` (app/Main.hs:420-440,494-509):
the full sampler state (state batch, per-chain tuning, RNG key, iteration
counter) is written as ``<analysis>.mcmc.npz`` plus a JSON sidecar with the
cycle shape, so ``continue`` resumes exactly and ``--init-from-save`` can
warm-start a new analysis (tuning is reused iff the proposal cycle shape
matches, app/Main.hs:434-440).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..models.state import FIELDS, State
from ..utils import device as devices

FORMAT_VERSION = 1


def checkpoint_file(analysis_name: str) -> str:
    return analysis_name + ".mcmc.npz"


def meta_file(analysis_name: str) -> str:
    return analysis_name + ".mcmc.json"


def trace_file(analysis_name: str) -> str:
    return analysis_name + ".trace.npz"


def _atomic_write(path: str, writer):
    """Write via a temp file in the same directory + ``os.replace`` so a
    crash mid-write can never corrupt the only copy (the reference's
    ``Save`` rewrites its JSON checkpoint wholesale each period; a torn
    write there loses the chain — here the rename is atomic)."""
    tmp = path + ".tmp"
    writer(tmp)
    os.replace(tmp, path)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _savez(path: str, arrays: dict):
    """savez through a file object (a bare non-.npz path would get ".npz"
    appended, breaking the atomic tmp+rename)."""
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def save_trace(analysis_name: str, draws: dict, out_dir: str = "."):
    """Persist the cross-chain scalar/node-age trace ``{name: [draws,
    chains]}`` next to the checkpoint.  The reference's ``Save`` serializes
    the full chain INCLUDING the trace (app/Main.hs:453), so ``continue``
    resumes diagnostics over the whole history — this sidecar provides the
    same capability."""
    arrays = {k: np.asarray(v, np.float32) for k, v in draws.items()}
    path = os.path.join(out_dir, trace_file(analysis_name))
    _atomic_write(path, lambda tmp: _savez(tmp, arrays))


def load_trace(analysis_name: str, in_dir: str = ".") -> Optional[dict]:
    """Load a saved trace, or None if the analysis has none."""
    path = os.path.join(in_dir, trace_file(analysis_name))
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def save(
    analysis_name: str,
    state: State,
    tuning,
    key,
    iteration: int,
    n_proposals: int,
    out_dir: str = ".",
    extra: Optional[dict] = None,
    extra_arrays: Optional[dict] = None,
):
    """Write the checkpoint: the state, tuning and key arrays plus
    ``extra_arrays`` (the NUTS adaptation state) in the ``.npz``, and the
    meta with ``extra`` (``{"hamiltonian": True}``) in the JSON sidecar."""
    arrays = state.numpy()
    arrays["tuning"] = _host(tuning)
    arrays["key"] = np.asarray(key)
    if extra_arrays:
        arrays.update({k: _host(v) for k, v in extra_arrays.items()})
    path = os.path.join(out_dir, checkpoint_file(analysis_name))
    _atomic_write(path, lambda tmp: _savez(tmp, arrays))
    meta = {
        "format_version": FORMAT_VERSION,
        "iteration": int(iteration),
        "n_proposals": int(n_proposals),
        "dtype": str(arrays["heights"].dtype),
    }
    if extra:
        meta.update(extra)

    def _write_meta(tmp):
        with open(tmp, "w") as fh:
            json.dump(meta, fh)

    _atomic_write(os.path.join(out_dir, meta_file(analysis_name)), _write_meta)


def load(analysis_name: str, dtype=None, in_dir: str = ".", device="cuda"):
    """Returns (state, tuning, key, meta) with the state and tuning as
    tensors on ``device`` (the card unless the caller asks for the CPU).

    ``dtype=None`` restores the precision the run was saved with (recorded
    in the JSON sidecar; falls back to the npz array dtype).
    """
    device = devices.resolve(device)
    path = os.path.join(in_dir, checkpoint_file(analysis_name))
    with open(os.path.join(in_dir, meta_file(analysis_name))) as fh:
        meta = json.load(fh)
    with np.load(path) as z:
        if dtype is None:
            dtype = getattr(torch, meta.get("dtype", str(z["heights"].dtype)))
        state = State.from_arrays({k: z[k] for k in FIELDS}, dtype=dtype, device=device)
        tuning = torch.as_tensor(z["tuning"], dtype=dtype, device=device)
        key = np.asarray(z["key"])
    return state, tuning, key, meta



def load_arrays(analysis_name: str, names, in_dir: str = ".") -> dict:
    """Extra saved arrays by name (the NUTS adaptation state); names the
    checkpoint lacks are left out."""
    path = os.path.join(in_dir, checkpoint_file(analysis_name))
    with np.load(path) as z:
        return {n: np.asarray(z[n]) for n in names if n in z.files}
