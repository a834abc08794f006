"""Host-side chemistry: SMILES parsing, perception, featurization, fragmentation.

Two backends:
  * ``minichem`` — the built-in pure-Python engine (always available).
  * ``rdkit``   — used automatically for parsing/fragmentation/conformers when
    rdkit is importable (it is not in minimal TPU images).

Everything here runs on the host CPU and emits NumPy arrays; no JAX.
Reference capability map: fragnet/dataset/{fragments,features,feature_utils}.py
"""

from fragnet_tpu_torch.chem.mol import Atom, Bond, Molecule
from fragnet_tpu_torch.chem.smiles import MolFromSmiles, MolToSmiles, SmilesError
from fragnet_tpu_torch.chem.features import FeaturesEXP
from fragnet_tpu_torch.chem.fragments import FragmentedMol, Fragment, Connection
from fragnet_tpu_torch.chem.geometry import embed_3d

__all__ = [
    "Atom",
    "Bond",
    "Molecule",
    "MolFromSmiles",
    "MolToSmiles",
    "SmilesError",
    "FeaturesEXP",
    "FragmentedMol",
    "Fragment",
    "Connection",
    "embed_3d",
]
