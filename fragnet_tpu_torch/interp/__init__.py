"""Interpretability: the four attention-weight levels + masking-based
contribution attribution + renderings — the re-design of fragnet/vizualize/
(counterpart of fragnet_tpu/interp/).

The reference runs one full forward with a deep-copied model per masked
atom/bond/connection (viz.py:901-1167); here each attribution family is one
forward over a batch of masked replicas of the molecule, through the GAT
kernels on the card.
"""

from fragnet_tpu_torch.interp.attention import FragNetInterpreter
from fragnet_tpu_torch.interp.attribution import (
    atom_contributions,
    bond_contributions,
    fconn_contributions,
    fragment_contributions,
)

__all__ = [
    "FragNetInterpreter",
    "atom_contributions",
    "bond_contributions",
    "fconn_contributions",
    "fragment_contributions",
]
