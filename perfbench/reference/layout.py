"""Where each molecule's rows sit in a padded batch, worked out again from
the molecules alone: the padded node counts of the four node axes
(atoms, bonds, fragments, fragment connections) and each molecule's
first row on each axis.

This is the sizing rule that the program states for its tile-aligned
batches (a frozen copy of ``fragnet_tpu_torch/graphs/hiergraph.py``'s
``spec_for`` node capacities and ``_aligned_starts``): a molecule that
would straddle a ``tn``-row tile starts at the next tile; the capacities
are the window-sum estimate, raised to cover the alignment measured on
probe windows, rounded up to 256. The reference needs them only because
dropout draws its mask over the padded rows, so its tensors must have the
program's padded shapes and its real rows the program's places.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

AXES = ("atom", "bond", "frag", "fc")
_COUNT = {"atom": "n_atoms", "bond": "n_edges", "frag": "n_frags",
          "fc": "n_fconn"}
TN, TE = 128, 256


def counts(graphs: Sequence, axis: str) -> np.ndarray:
    return np.array([getattr(g, _COUNT[axis]) for g in graphs], np.int64)


def aligned_starts(cnt: np.ndarray, tn: int) -> np.ndarray:
    """(n + 1,) first rows; the last is the aligned total."""
    offs = np.zeros((len(cnt) + 1,), np.int64)
    pos = 0
    for i, c in enumerate(cnt):
        c = int(c)
        if c <= tn and (pos % tn) + c > tn:
            pos = ((pos + tn - 1) // tn) * tn
        offs[i] = pos
        pos += c
    offs[-1] = pos
    return offs


def tiles(probe: Sequence) -> Dict[str, int]:
    """Each axis's tile: 128 rows, or 256 where the largest molecule has
    more than 128 rows there and at most 256."""
    out = {}
    for ax in AXES:
        mx = int(counts(probe, ax).max())
        out[ax] = 256 if TN < mx <= 256 else TN
    return out


def padded_rows(probe: Sequence, batch_size: int, slack: float = 1.1
                ) -> Dict[str, int]:
    """Each node axis's padded row count for batches of ``batch_size``
    molecules, from the probe molecules."""
    tn = tiles(probe)
    out = {}
    for ax in AXES:
        arr = counts(probe, ax)
        if batch_size <= 4:      # any batch_size molecules fit
            cap = int(arr.max() * min(batch_size, len(arr)))
        else:
            cap = int(batch_size * arr.mean() * max(slack - 0.1, 1.0)
                      + 4.0 * arr.std() * np.sqrt(batch_size)
                      + 2 * arr.max())
        n = len(probe)
        step = max(1, (n - batch_size) // 8 or 1)
        for lo in list(range(0, max(1, n - batch_size + 1), step))[:9]:
            win = counts(probe[lo:lo + batch_size], ax)
            cap = max(cap, int(aligned_starts(win, tn[ax])[-1] * slack))
        mult = max(8, TN, TE, *tn.values())
        out[ax] = ((cap + mult - 1) // mult) * mult
    return out
