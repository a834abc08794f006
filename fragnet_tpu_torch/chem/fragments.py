"""Fragmentation: BRICS-like and Murcko-linker bond cleavage + the four-level
connection bookkeeping.

Mirrors the behavior of fragnet/dataset/fragments.py:
  * ``FragmentedMol``        — fragments.py:173-242
  * ``self_cn`` connection for single-fragment molecules — fragments.py:230-234
  * ``iso_cn3`` connections between disconnected components — fragments.py:236-241,273-301
  * Murcko link bonds        — fragments.py:15-31

Backend notes: with RDKit importable, ``find_brics_bonds`` delegates to
``rdkit.Chem.BRICS.FindBRICSBonds`` (the exact reference rule set). The
built-in fallback implements a BRICS-style rule subset: retrosynthetically
interesting acyclic single bonds, never producing single-heavy-atom leaves.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from fragnet_tpu_torch.chem.mol import (
    BOND_DOUBLE,
    BOND_SINGLE,
    BOND_TRIPLE,
    Molecule,
)

try:  # pragma: no cover - exercised only when rdkit exists
    from rdkit.Chem import BRICS as _RDKIT_BRICS  # type: ignore

    _HAVE_RDKIT = True
except Exception:  # pragma: no cover
    _HAVE_RDKIT = False


# ---------------------------------------------------------------------------
# Murcko scaffold
# ---------------------------------------------------------------------------

def murcko_scaffold_atoms(mol: Molecule) -> List[int]:
    """Atom indices of the Bemis–Murcko scaffold (RDKit GetScaffoldForMol
    semantics): (a) iteratively prune all non-ring leaves, leaving ring
    systems plus the linkers between them; (b) re-add atoms attached to that
    core by a double/triple bond (exocyclic =O on linkers, etc.)."""
    n = mol.GetNumAtoms()
    if not any(a.in_ring for a in mol.atoms):
        return []
    keep = [True] * n
    changed = True
    while changed:
        changed = False
        for a in mol.atoms:
            if not keep[a.idx] or a.in_ring:
                continue
            live_deg = sum(
                1
                for v in mol.neighbors(a.idx)
                if keep[v]
            )
            if live_deg <= 1:
                keep[a.idx] = False
                changed = True
    # phase (b): exocyclic multiple-bond attachments to the core
    for b in mol.bonds:
        if b.order in (BOND_DOUBLE, BOND_TRIPLE) and not b.is_aromatic:
            if keep[b.begin] and not keep[b.end]:
                keep[b.end] = True
            elif keep[b.end] and not keep[b.begin]:
                keep[b.begin] = True
    return [i for i in range(n) if keep[i]]


def find_murcko_link_bonds(mol: Molecule) -> List[Tuple[int, int]]:
    """Bonds with exactly one endpoint inside the Murcko scaffold.
    Reference: fragments.py:15-31."""
    scaffold = set(murcko_scaffold_atoms(mol))
    out = []
    for bond in mol.GetBonds():
        u, v = bond.begin, bond.end
        if (u in scaffold) + (v in scaffold) == 1:
            out.append((u, v))
    return out


# ---------------------------------------------------------------------------
# BRICS-like bonds
# ---------------------------------------------------------------------------

def _heavy_neighbors(mol: Molecule, idx: int) -> List[int]:
    return [v for v in mol.neighbors(idx) if mol.atoms[v].symbol != "H"]


def _is_carbonyl_carbon(mol: Molecule, idx: int) -> bool:
    a = mol.atoms[idx]
    if a.symbol != "C":
        return False
    for bi in mol.adjacency[idx]:
        b = mol.bonds[bi]
        other = b.end if b.begin == idx else b.begin
        if b.order == BOND_DOUBLE and mol.atoms[other].symbol in ("O", "S"):
            return True
    return False


def _fragment_sizes_if_cut(mol: Molecule, u: int, v: int) -> Tuple[int, int]:
    """Heavy-atom sizes of the two components created by cutting bond (u, v)."""
    def reach(start: int, forbid: Tuple[int, int]) -> int:
        seen = {start}
        stack = [start]
        cnt = 0
        while stack:
            x = stack.pop()
            if mol.atoms[x].symbol != "H":
                cnt += 1
            for y in mol.neighbors(x):
                if (x, y) == forbid or (y, x) == forbid:
                    continue
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return cnt

    return reach(u, (u, v)), reach(v, (u, v))


def find_brics_bonds_fallback(mol: Molecule) -> List[Tuple[int, int]]:
    """BRICS-style cleavable bonds without RDKit.

    Rules (an approximation of the 16 BRICS environments):
      * single, non-aromatic, acyclic bonds between heavy atoms
      * at least one endpoint is "activating": a ring atom, an N/O/S
        heteroatom, or a carbonyl carbon
      * never cleave C–halogen or bonds to H
      * never produce a fragment with < 2 heavy atoms
      * never cleave O–C or N–C of an ester/amide on the O/N side when the
        other side is the carbonyl? — BRICS does cut these (L1-L3/L5);
        we keep them cleavable.
    """
    halogens = {"F", "Cl", "Br", "I"}
    out: List[Tuple[int, int]] = []
    for bond in mol.GetBonds():
        if bond.is_aromatic or bond.order != BOND_SINGLE or bond.in_ring:
            continue
        u, v = bond.begin, bond.end
        au, av = mol.atoms[u], mol.atoms[v]
        if au.symbol == "H" or av.symbol == "H":
            continue
        if au.symbol in halogens or av.symbol in halogens:
            continue
        activating = (
            au.in_ring
            or av.in_ring
            or au.symbol in ("N", "O", "S")
            or av.symbol in ("N", "O", "S")
            or _is_carbonyl_carbon(mol, u)
            or _is_carbonyl_carbon(mol, v)
        )
        if not activating:
            continue
        su, sv = _fragment_sizes_if_cut(mol, u, v)
        if su < 2 or sv < 2:
            continue
        out.append((u, v))
    return out


def find_brics_bonds(mol) -> List[Tuple[int, int]]:
    if _HAVE_RDKIT and not isinstance(mol, Molecule):  # pragma: no cover
        return [tuple(b[0]) for b in _RDKIT_BRICS.FindBRICSBonds(mol)]
    return find_brics_bonds_fallback(mol)


# ---------------------------------------------------------------------------
# FragmentedMol
# ---------------------------------------------------------------------------

class Fragment:
    """A fragment: atom/bond index sets into the parent mol.
    Reference: fragments.py:111-137."""

    def __init__(self, graph: "FragmentedMol", atom_indices: Sequence[int], FragIdx: int = 0):
        self.FragIdx = FragIdx
        self.graph = graph
        atom_set = set(atom_indices)
        bond_indices = []
        for bond in graph.mol.GetBonds():
            if bond.begin in atom_set and bond.end in atom_set:
                bond_indices.append(bond.idx)
        self.atom_indices = tuple(atom_indices)
        self.bond_indices = tuple(bond_indices)
        self.neighbors: List[Fragment] = []
        self.connections: List["Connection"] = []

    def add_connection(self, neighbor: "Fragment", connection: "Connection") -> None:
        self.neighbors.append(neighbor)
        self.connections.append(connection)


class _EmptyBond:
    """Featureless bond stub for self_cn / iso_cn3 connections.
    Reference: fragments.py:139-153."""

    def GetIsConjugated(self):
        return False

    def GetBondDir(self):
        return "NONE"

    def IsInRing(self):
        return False

    def GetStereo(self):
        return "STEREONONE"


class Connection:
    """A connection between two fragments. bond_type is a bond-type string
    ("SINGLE"/...), "self_cn", or "iso_cn3". Reference: fragments.py:156-171."""

    def __init__(self, frag1, frag2, atom_id1, atom_id2, bond_index, bond_type, bond):
        frag1.add_connection(frag2, self)
        frag2.add_connection(frag1, self)
        self.frags = (frag1, frag2)
        self.atom_indices = (atom_id1, atom_id2)
        self.bond_id = bond_index
        self.bond_type = bond_type
        self.BeginFragIdx = frag1.FragIdx
        self.EndFragIdx = frag2.FragIdx
        self.bond = bond


class FragmentedMol:
    """Break a molecule on BRICS or Murcko-linker bonds; build Fragment and
    Connection objects including ``self_cn`` and ``iso_cn3`` cases.
    Reference: fragments.py:173-242."""

    def __init__(self, mol: Molecule, conf=None, frag_type: str = "brics"):
        self.mol = mol
        self.conf = conf

        if frag_type == "brics":
            frag_bonds = find_brics_bonds(mol)
        elif frag_type == "murcko":
            frag_bonds = find_murcko_link_bonds(mol)
        else:
            raise ValueError(f"unknown frag_type {frag_type!r}")
        frag_bonds = [tuple(fb) for fb in frag_bonds]

        # fragments = connected components after removing frag bonds
        cut = set()
        for u, v in frag_bonds:
            cut.add((min(u, v), max(u, v)))
        comps = _components_excluding(mol, cut)

        fragments = [Fragment(self, atoms, FragIdx=i) for i, atoms in enumerate(comps)]
        self.fragments = fragments
        self.atom_to_frag_id = self._atom_to_frag_id()

        frag_of_atom: Dict[int, Fragment] = {}
        for frag in fragments:
            for a in frag.atom_indices:
                frag_of_atom[a] = frag

        connections: List[Connection] = []
        for atom_id1, atom_id2 in frag_bonds:
            bond = mol.GetBondBetweenAtoms(atom_id1, atom_id2)
            connections.append(
                Connection(
                    frag_of_atom[atom_id1],
                    frag_of_atom[atom_id2],
                    atom_id1,
                    atom_id2,
                    bond.idx,
                    bond.GetBondType(),
                    bond,
                )
            )

        # single-fragment molecule: fragment connects to itself
        if len(connections) == 0 and len(fragments) == 1:
            connections = [
                Connection(
                    fragments[0], fragments[0], None, None, None, "self_cn", _EmptyBond()
                )
            ]

        # disconnected molecules: link fragments across components ("iso_cn3")
        if len(mol.connected_components()) > 1:
            sg_frags = self._atoms_in_molfrags()
            connections = connections + self._connections_bw_molfrags(sg_frags)

        self.connections = tuple(connections)

    def _atom_to_frag_id(self) -> Dict[int, int]:
        m: Dict[int, int] = {}
        for i, f in enumerate(self.fragments):
            for a in f.atom_indices:
                m[a] = i
        return dict(sorted(m.items()))

    def _atoms_in_molfrags(self):
        mol_frags = self.mol.connected_components()
        sg_frags = defaultdict(list)
        for i, mf in enumerate(mol_frags):
            sg = set(mf)
            for frag in self.fragments:
                if set(frag.atom_indices).issubset(sg):
                    sg_frags[i].append(frag)
        return sg_frags

    def _connections_bw_molfrags(self, sg_frags) -> List[Connection]:
        """All-pairs links between fragments of different components, skipping
        already-connected pairs. Reference: fragments.py:273-301."""
        new_connections: List[Connection] = []
        bond = _EmptyBond()
        for i in range(len(sg_frags)):
            for j in range(i + 1, len(sg_frags)):
                for fragi in sg_frags[i]:
                    existing = [
                        tuple(sorted((c.BeginFragIdx, c.EndFragIdx)))
                        for c in fragi.connections
                    ]
                    for fragj in sg_frags[j]:
                        if tuple(sorted((fragi.FragIdx, fragj.FragIdx))) not in existing:
                            new_connections.append(
                                Connection(fragi, fragj, None, None, None, "iso_cn3", bond)
                            )
        return new_connections


def _components_excluding(mol: Molecule, cut: set) -> List[Tuple[int, ...]]:
    n = mol.GetNumAtoms()
    seen = [False] * n
    comps: List[Tuple[int, ...]] = []
    for root in range(n):
        if seen[root]:
            continue
        stack, comp = [root], []
        seen[root] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for bi in mol.adjacency[u]:
                b = mol.bonds[bi]
                v = b.end if b.begin == u else b.begin
                if (min(u, v), max(u, v)) in cut:
                    continue
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        comps.append(tuple(sorted(comp)))
    return comps
