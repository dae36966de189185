"""Render checkpoints (counterpart of core_tpu/checkpoint.py).

A progressive render's state between AA passes is its film and the
pass / sample counters, which fix the QMC streams of what is left; SPPM's is
its per-pixel hit points and the pass counter.  Both are saved as core_tpu
saves them: one .npz with the same keys and magic strings, written to a
temporary file and moved into place.  So a checkpoint written by either
package resumes in the other, and a resumed render equals an uninterrupted
one.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from core_tpu_torch.film import Film
from core_tpu_torch.vec import v3

MAGIC = "core_tpu_checkpoint_v1"
SPPM_MAGIC = "core_tpu_sppm_checkpoint_v1"


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def save_checkpoint(path: str, film: Film, pass_idx: int, sample_offs: int,
                    meta: dict | None = None):
    """The film and the progress counters, written atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, magic=MAGIC, rgba=_np(film.rgba),
                 weight=_np(film.weight), density=_np(film.density),
                 n_density=_np(film.n_density), pass_idx=pass_idx,
                 sample_offs=sample_offs, meta=json.dumps(meta or {}))
    os.replace(tmp, path)


def load_checkpoint(path: str, *, device):
    """(film on `device`, pass_idx, sample_offs, meta), or None when there
    is no file at `path`."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != MAGIC:
            raise ValueError(f"{path} is not a render checkpoint")

        def t(key):
            return torch.as_tensor(np.asarray(z[key], np.float32),
                                   device=device)
        film = Film(*(t(f) for f in Film._fields))
        return (film, int(z["pass_idx"]), int(z["sample_offs"]),
                json.loads(str(z["meta"])))


def save_sppm_checkpoint(path: str, state, pass_idx: int):
    """SPPM's hit points (r2, acc_n, tau, direct; tau and direct as [N, 3])
    and the next pass index, written atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, magic=SPPM_MAGIC, r2=_np(state.r2),
                 acc_n=_np(state.acc_n),
                 tau=_np(torch.stack(list(state.tau), -1)),
                 direct=_np(torch.stack(list(state.direct), -1)),
                 pass_idx=pass_idx)
    os.replace(tmp, path)


def load_sppm_checkpoint(path: str, *, device):
    """(HitPoints on `device`, pass_idx), or None when there is no file."""
    if not os.path.exists(path):
        return None
    from core_tpu_torch.integrators.sppm import HitPoints
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != SPPM_MAGIC:
            raise ValueError(f"{path} is not an SPPM checkpoint")

        def t(key):
            return torch.as_tensor(np.asarray(z[key], np.float32),
                                   device=device)
        return HitPoints(r2=t("r2"), acc_n=t("acc_n"), tau=v3(t("tau")),
                         direct=v3(t("direct"))), int(z["pass_idx"])
