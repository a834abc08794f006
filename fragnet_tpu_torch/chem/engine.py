"""Backend dispatch: RDKit when importable, the pure-Python minichem engine
otherwise.

High-level entry points used by the data pipeline:
  * ``mol_3d(smiles)``        — H-added mol + one conformer
    (reference get_3Dcoords, fragnet/dataset/fragments.py:41-73)
  * ``mol_3d_multi(smiles)``  — H-added mol + multiple conformers + energies
    (reference get_3Dcoords2, fragments.py:76-108)
  * ``murcko_scaffold_smiles(smiles)`` — scaffold SMILES for splits
    (reference splitters_molebert.py:13-29)
  * ``canonicalize(smiles)``  — canonical SMILES for dedup
"""

from __future__ import annotations

from typing import List, Optional, Tuple

try:  # pragma: no cover
    from rdkit import Chem as _Chem  # type: ignore
    from rdkit.Chem import AllChem as _AllChem  # type: ignore
    from rdkit.Chem.Scaffolds import MurckoScaffold as _Murcko  # type: ignore

    HAVE_RDKIT = True
except Exception:  # pragma: no cover
    HAVE_RDKIT = False

from fragnet_tpu_torch.chem import geometry, smiles as smi
from fragnet_tpu_torch.chem.mol import Molecule


def backend_name() -> str:
    return "rdkit" if HAVE_RDKIT else "minichem"


# ---------------------------------------------------------------------------
# minichem path
# ---------------------------------------------------------------------------

def _mini_mol_3d(s: str, seed: int = 42):
    mol = smi.MolFromSmiles(s)
    if mol is None:
        return None
    molh = mol.add_hs()
    conf = geometry.embed_3d(molh, seed=seed)
    return molh, conf


def _mini_mol_3d_multi(s: str, num_conf: int, seed: int, max_iters: int):
    mol = smi.MolFromSmiles(s)
    if mol is None:
        return None
    molh = mol.add_hs()
    return geometry.embed_multiconf(molh, num_conf=num_conf, seed=seed, max_iters=max_iters)


# ---------------------------------------------------------------------------
# rdkit path
# ---------------------------------------------------------------------------

if HAVE_RDKIT:  # pragma: no cover

    class _RdConformer:
        """Adapter exposing the Conformer surface used by the graph builder."""

        def __init__(self, rd_conf, energy: float = 0.0):
            self._conf = rd_conf
            self.energy = energy

        def GetPositions(self):
            return self._conf.GetPositions()

        def angle_rad(self, i, j, k):
            from rdkit.Chem import rdMolTransforms

            return rdMolTransforms.GetAngleRad(self._conf, int(i), int(j), int(k))

    def _rd_mol_3d(s: str, seed: int = 42):
        mol = _Chem.MolFromSmiles(s)
        if mol is None:
            return None
        mol = _AllChem.AddHs(mol)
        res = _AllChem.EmbedMolecule(mol, randomSeed=seed)
        if res == -1:
            mol2 = _Chem.MolFromSmiles(s)
            _AllChem.EmbedMolecule(mol2, maxAttempts=5000, randomSeed=seed)
            mol = _AllChem.AddHs(mol2, addCoords=True)
        try:
            _AllChem.MMFFOptimizeMolecule(mol)
        except Exception:
            pass
        if mol.GetNumConformers() == 0:
            _AllChem.Compute2DCoords(mol)
        return mol, _RdConformer(mol.GetConformer())

    def _rd_mol_3d_multi(s: str, num_conf: int, seed: int, max_iters: int):
        from rdkit.Chem import rdDistGeom

        mol = _Chem.AddHs(_Chem.MolFromSmiles(s))
        param = rdDistGeom.ETKDGv2()
        param.pruneRmsThresh = 0.1
        param.randomSeed = seed
        cids = rdDistGeom.EmbedMultipleConfs(mol, num_conf, param)
        mp = _AllChem.MMFFGetMoleculeProperties(mol, mmffVariant="MMFF94s")
        try:
            o = _AllChem.MMFFOptimizeMoleculeConfs(
                mol, numThreads=0, mmffVariant="MMFF94s", maxIters=max_iters
            )
        except Exception:
            return None
        if not o:
            return None
        res = []
        for i, cid in enumerate(cids):
            if o[i][0] != 0:
                return None
            ff = _AllChem.MMFFGetMoleculeForceField(mol, mp, confId=cid)
            e = ff.CalcEnergy()
            res.append((_RdConformer(mol.GetConformer(cid), e), e))
        return mol, res


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def mol_3d(s: str, seed: int = 42):
    """H-added mol + single optimized conformer, or None on parse failure."""
    if HAVE_RDKIT:  # pragma: no cover
        return _rd_mol_3d(s, seed=seed)
    return _mini_mol_3d(s, seed=seed)


def mol_3d_multi(s: str, num_conf: int = 1, seed: int = 42, max_iters: int = 200):
    """H-added mol + [(conformer, energy)] list, or None on failure."""
    if HAVE_RDKIT:  # pragma: no cover
        return _rd_mol_3d_multi(s, num_conf, seed, max_iters)
    return _mini_mol_3d_multi(s, num_conf, seed, max_iters)


def canonicalize(s: str) -> Optional[str]:
    if HAVE_RDKIT:  # pragma: no cover
        m = _Chem.MolFromSmiles(s)
        return _Chem.MolToSmiles(m) if m is not None else None
    return smi.canonical_smiles(s)


def murcko_scaffold_smiles(s: str, include_chirality: bool = False) -> Optional[str]:
    """Scaffold SMILES used as the scaffold-split key. Both reference
    splitters pass include_chirality=True (splitters_molebert.py:79,
    splitters.py:61) — stereo SMILES must yield stereo-distinct keys."""
    if HAVE_RDKIT:  # pragma: no cover
        return _Murcko.MurckoScaffoldSmiles(smiles=s, includeChirality=include_chirality)
    from fragnet_tpu_torch.chem.fragments import murcko_scaffold_atoms

    mol = smi.MolFromSmiles(s)
    if mol is None:
        return None
    atoms = murcko_scaffold_atoms(mol)
    if not atoms:
        return ""
    sub = _extract_submol(mol, atoms, include_chirality=include_chirality)
    return smi.MolToSmiles(sub)


def _extract_submol(mol: Molecule, atom_indices,
                    include_chirality: bool = True) -> Molecule:
    from fragnet_tpu_torch.chem.mol import CHI_UNSPECIFIED, Atom

    keep = sorted(atom_indices)
    keep_set = set(keep)
    remap = {a: i for i, a in enumerate(keep)}
    out = Molecule()

    for a_idx in keep:
        a = mol.atoms[a_idx]
        tag = a.chiral_tag if include_chirality else CHI_UNSPECIFIED
        # Remap the written neighbor order so the writer can recompute @/@@
        # parity in the submol. Each removed substituent becomes an implicit
        # H: one removal substitutes -1 in place (parity preserved); two or
        # more leave ≥2 equivalent Hs — no longer a stereocenter, drop the tag.
        order = None
        if tag != CHI_UNSPECIFIED and a.parse_nbr_order is not None:
            order = []
            for v in a.parse_nbr_order:
                if v == -1 or v in keep_set:
                    order.append(remap[v] if v != -1 else -1)
                else:
                    order.append(-1)
            if order.count(-1) > 1:  # ≥2 equivalent Hs → not a stereocenter
                tag, order = CHI_UNSPECIFIED, None
        new = Atom(
            symbol=a.symbol,
            formal_charge=a.formal_charge,
            explicit_hs=None,
            is_aromatic=a.is_aromatic,
            chiral_tag=tag,
            isotope=a.isotope,
        )
        new.parse_nbr_order = order
        out.add_atom(new)
    for b in mol.bonds:
        if b.begin in remap and b.end in remap:
            out.add_bond(remap[b.begin], remap[b.end], b.order, b.is_aromatic)
    return out.finalize()
