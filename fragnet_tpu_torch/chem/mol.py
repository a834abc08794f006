"""Pure-Python molecular data model ("minichem").

A light-weight replacement for the RDKit Mol object covering exactly the
perception the FragNet feature stack needs (reference:
fragnet/dataset/features.py:39-162): element, degree, implicit valence, formal
charge, radical electrons, hybridization, aromaticity, ring membership,
chirality tag, total H count; and per-bond: order, conjugation, ring
membership, stereo, bond direction.

Perception algorithms here are deliberately simple and deterministic; when the
real RDKit is importable the higher-level entry points use it instead (see
fragnet_tpu_torch.chem.engine).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Periodic table (symbol -> atomic number), organic-subset default valences.
# ---------------------------------------------------------------------------

PERIODIC_TABLE: Dict[str, int] = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57,
    "Ce": 58, "Pr": 59, "Nd": 60, "Pm": 61, "Sm": 62, "Eu": 63, "Gd": 64,
    "Tb": 65, "Dy": 66, "Ho": 67, "Er": 68, "Tm": 69, "Yb": 70, "Lu": 71,
    "Hf": 72, "Ta": 73, "W": 74, "Re": 75, "Os": 76, "Ir": 77, "Pt": 78,
    "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83, "Po": 84, "At": 85,
    "Rn": 86, "Fr": 87, "Ra": 88, "Ac": 89, "Th": 90, "Pa": 91, "U": 92,
}
SYMBOL_BY_NUM = {v: k for k, v in PERIODIC_TABLE.items()}

# Daylight-style default valences for implicit-H computation.
DEFAULT_VALENCES: Dict[str, Tuple[int, ...]] = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
    "H": (1,),
}

# Atoms in the SMILES "organic subset" (may appear without brackets).
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}

# Hybridization labels mirror rdkit.Chem.rdchem.HybridizationType names.
HYB_S = "S"
HYB_SP = "SP"
HYB_SP2 = "SP2"
HYB_SP3 = "SP3"
HYB_SP3D = "SP3D"
HYB_SP3D2 = "SP3D2"
HYB_UNSPECIFIED = "UNSPECIFIED"

# Chiral tags mirror rdkit.Chem.rdchem.ChiralType names.
CHI_UNSPECIFIED = "CHI_UNSPECIFIED"
CHI_TETRAHEDRAL_CW = "CHI_TETRAHEDRAL_CW"    # @@
CHI_TETRAHEDRAL_CCW = "CHI_TETRAHEDRAL_CCW"  # @

# Bond orders; aromatic carries its own label (no kekulization needed by the
# feature stack — AROMATIC is its own one-hot category, features.py:102).
BOND_SINGLE = "SINGLE"
BOND_DOUBLE = "DOUBLE"
BOND_TRIPLE = "TRIPLE"
BOND_AROMATIC = "AROMATIC"
BOND_ORDER_VALUE = {BOND_SINGLE: 1.0, BOND_DOUBLE: 2.0, BOND_TRIPLE: 3.0, BOND_AROMATIC: 1.5}

# Bond stereo labels mirror rdkit str(bond.GetStereo()).
STEREO_NONE = "STEREONONE"
STEREO_ANY = "STEREOANY"
STEREO_Z = "STEREOZ"
STEREO_E = "STEREOE"

# Bond direction labels mirror rdkit.Chem.rdchem.BondDir names.
DIR_NONE = "NONE"
DIR_ENDUPRIGHT = "ENDUPRIGHT"      # '/'
DIR_ENDDOWNRIGHT = "ENDDOWNRIGHT"  # '\'
DIR_BEGINWEDGE = "BEGINWEDGE"
DIR_BEGINDASH = "BEGINDASH"


@dataclasses.dataclass
class Atom:
    symbol: str
    idx: int = 0
    formal_charge: int = 0
    explicit_hs: Optional[int] = None  # set by bracket atoms, else None
    is_aromatic: bool = False
    chiral_tag: str = CHI_UNSPECIFIED
    isotope: int = 0
    n_radical_electrons: int = 0
    # perception results (filled by Molecule.finalize)
    implicit_hs: int = 0
    in_ring: bool = False
    hybridization: str = HYB_UNSPECIFIED
    # SMILES-written neighbor order for chiral atoms (atom indices; -1 marks
    # the in-bracket implicit H slot). Filled by the parser; the writer uses
    # it to recompute @/@@ parity relative to the OUTPUT neighbor order —
    # the tag symbol is only meaningful w.r.t. a specific listing order.
    parse_nbr_order: Optional[List[int]] = dataclasses.field(
        default=None, repr=False)
    _mol: Optional["Molecule"] = dataclasses.field(default=None, repr=False)

    @property
    def atomic_num(self) -> int:
        return PERIODIC_TABLE.get(self.symbol, 0)

    # --- RDKit-compatible accessors (used by the featurizer) ---
    def GetAtomicNum(self) -> int:
        return self.atomic_num

    def GetDegree(self) -> int:
        return len(self._mol.adjacency[self.idx])

    def GetImplicitValence(self) -> int:
        return 0 if self.explicit_hs is not None else self.implicit_hs

    def GetFormalCharge(self) -> int:
        return self.formal_charge

    def GetNumRadicalElectrons(self) -> int:
        return self.n_radical_electrons

    def GetHybridization(self) -> str:
        return self.hybridization

    def GetIsAromatic(self) -> bool:
        return self.is_aromatic

    def IsInRing(self) -> bool:
        return self.in_ring

    def GetChiralTag(self) -> str:
        return self.chiral_tag

    def GetTotalNumHs(self) -> int:
        if self.explicit_hs is not None:
            return self.explicit_hs
        return self.implicit_hs

    def GetIdx(self) -> int:
        return self.idx


@dataclasses.dataclass
class Bond:
    begin: int
    end: int
    order: str = BOND_SINGLE
    idx: int = 0
    is_aromatic: bool = False
    in_ring: bool = False
    is_conjugated: bool = False
    stereo: str = STEREO_NONE
    direction: str = DIR_NONE

    # --- RDKit-compatible accessors ---
    def GetBeginAtomIdx(self) -> int:
        return self.begin

    def GetEndAtomIdx(self) -> int:
        return self.end

    def GetBondType(self) -> str:
        return BOND_AROMATIC if self.is_aromatic else self.order

    def GetBondTypeAsDouble(self) -> float:
        return BOND_ORDER_VALUE[self.GetBondType()]

    def GetIsConjugated(self) -> bool:
        return self.is_conjugated

    def IsInRing(self) -> bool:
        return self.in_ring

    def GetStereo(self) -> str:
        return self.stereo

    def GetBondDir(self) -> str:
        return self.direction

    def GetIdx(self) -> int:
        return self.idx


class Molecule:
    """A molecular graph with perception results.

    Construction: add atoms/bonds then call finalize() (done by the SMILES
    parser).  After finalize() the object is read-only by convention.
    """

    def __init__(self) -> None:
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self.adjacency: List[List[int]] = []  # atom idx -> list of bond indices
        self._bond_lookup: Dict[Tuple[int, int], int] = {}
        self.rings: List[List[int]] = []  # list of atom-index cycles (SSSR-ish)

    # -- construction ------------------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        atom._mol = self
        self.atoms.append(atom)
        self.adjacency.append([])
        return atom.idx

    def add_bond(self, begin: int, end: int, order: str = BOND_SINGLE,
                 is_aromatic: bool = False, direction: str = DIR_NONE) -> int:
        if begin == end:
            raise ValueError("self-bonds are not allowed")
        key = (min(begin, end), max(begin, end))
        if key in self._bond_lookup:
            raise ValueError(f"duplicate bond {key}")
        bond = Bond(begin=begin, end=end, order=order, is_aromatic=is_aromatic,
                    direction=direction)
        bond.idx = len(self.bonds)
        self.bonds.append(bond)
        self.adjacency[begin].append(bond.idx)
        self.adjacency[end].append(bond.idx)
        self._bond_lookup[key] = bond.idx
        return bond.idx

    def remove_bond(self, begin: int, end: int) -> None:
        """Remove a bond (used by fragmentation); re-indexes bonds."""
        key = (min(begin, end), max(begin, end))
        bidx = self._bond_lookup.pop(key)
        self.bonds.pop(bidx)
        for i, b in enumerate(self.bonds):
            b.idx = i
        self._bond_lookup = {
            (min(b.begin, b.end), max(b.begin, b.end)): b.idx for b in self.bonds
        }
        self.adjacency = [[] for _ in self.atoms]
        for b in self.bonds:
            self.adjacency[b.begin].append(b.idx)
            self.adjacency[b.end].append(b.idx)

    # -- lookups -----------------------------------------------------------
    def GetNumAtoms(self) -> int:
        return len(self.atoms)

    def GetNumBonds(self) -> int:
        return len(self.bonds)

    def GetAtoms(self) -> Sequence[Atom]:
        return self.atoms

    def GetBonds(self) -> Sequence[Bond]:
        return self.bonds

    def GetAtomWithIdx(self, i: int) -> Atom:
        return self.atoms[i]

    def GetBondWithIdx(self, i: int) -> Bond:
        return self.bonds[i]

    def GetBondBetweenAtoms(self, i: int, j: int) -> Optional[Bond]:
        b = self._bond_lookup.get((min(i, j), max(i, j)))
        return self.bonds[b] if b is not None else None

    def neighbors(self, i: int) -> List[int]:
        out = []
        for bidx in self.adjacency[i]:
            b = self.bonds[bidx]
            out.append(b.end if b.begin == i else b.begin)
        return out

    # -- perception --------------------------------------------------------
    def finalize(self) -> "Molecule":
        self._perceive_rings()
        self._perceive_aromaticity()
        self._perceive_implicit_hs()
        self._perceive_hybridization()
        self._perceive_conjugation()
        self._perceive_bond_stereo()
        return self

    def _perceive_rings(self) -> None:
        """Cycle perception via spanning-forest chords + BFS shortest cycles.

        Produces one shortest ring per non-tree ("chord") bond — an SSSR-style
        ring set sufficient for in_ring flags and aromaticity.
        """
        n = len(self.atoms)
        visited = [False] * n
        tree_bonds: set = set()
        parent = [-1] * n
        order: List[int] = []
        for root in range(n):
            if visited[root]:
                continue
            stack = [root]
            visited[root] = True
            while stack:
                u = stack.pop()
                order.append(u)
                for bidx in self.adjacency[u]:
                    b = self.bonds[bidx]
                    v = b.end if b.begin == u else b.begin
                    if not visited[v]:
                        visited[v] = True
                        parent[v] = u
                        tree_bonds.add(bidx)
                        stack.append(v)

        rings: List[List[int]] = []
        ring_atoms: set = set()
        ring_bonds: set = set()
        for b in self.bonds:
            if b.idx in tree_bonds:
                continue
            # shortest path begin..end avoiding this chord = the smallest ring
            path = self._shortest_path(b.begin, b.end, exclude_bond=b.idx)
            if path is None:
                continue
            rings.append(path)
            ring_atoms.update(path)
            for k in range(len(path)):
                rb = self.GetBondBetweenAtoms(path[k], path[(k + 1) % len(path)])
                if rb is not None:
                    ring_bonds.add(rb.idx)
        self.rings = rings
        for a in self.atoms:
            a.in_ring = a.idx in ring_atoms
        for b in self.bonds:
            b.in_ring = b.idx in ring_bonds

    def _shortest_path(self, s: int, t: int, exclude_bond: int) -> Optional[List[int]]:
        from collections import deque

        prev = {s: -1}
        q = deque([s])
        while q:
            u = q.popleft()
            if u == t:
                path = []
                while u != -1:
                    path.append(u)
                    u = prev[u]
                return path
            for bidx in self.adjacency[u]:
                if bidx == exclude_bond:
                    continue
                b = self.bonds[bidx]
                v = b.end if b.begin == u else b.begin
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        return None

    def _perceive_aromaticity(self) -> None:
        """Hückel-style aromatization of Kekulé input (an approximation of
        RDKit's default model; lowercase input flags are trusted as-is).

        Per SSSR ring, each atom contributes π electrons:
          * 1 if it sits on a double bond to a RING atom (in this ring or a
            fused one — naphthalene fusion atoms borrow from the other ring);
          * 0 if its only double bond is exocyclic to a non-ring atom
            (pyridinone/quinone carbonyl carbons — sp2 but no ring electron);
          * 2 for a N/O/S lone pair (no double bond: pyrrole NH, furan O,
            thiophene S) and for C⁻ (cyclopentadienyl); 0 for C⁺ (tropylium);
          * otherwise (saturated carbon, degree > 3) the ring is not aromatic.
        A ring with Σ ≡ 2 (mod 4) aromatizes; iterate to fixpoint so fused
        systems (naphthalene, indole written Kekulé) resolve regardless of
        ring order. Known gap vs RDKit: whole-system perception (azulene).
        """
        ring_atom_set = {a.idx for a in self.atoms if a.in_ring}

        def has_ring_double(i: int) -> bool:
            for bidx in self.adjacency[i]:
                b = self.bonds[bidx]
                if b.order == BOND_DOUBLE or b.is_aromatic:
                    j = b.end if b.begin == i else b.begin
                    if j in ring_atom_set:
                        return True
            return False

        def has_any_double(i: int) -> bool:
            return any(
                self.bonds[bidx].order in (BOND_DOUBLE, BOND_TRIPLE)
                or self.bonds[bidx].is_aromatic
                for bidx in self.adjacency[i]
            )

        def contribution(i: int):
            a = self.atoms[i]
            if len(self.adjacency[i]) > 3:
                return None
            if has_ring_double(i):
                return 1
            if has_any_double(i):
                return 0  # exocyclic C=O etc.: sp2, no ring electron
            if a.symbol in ("N", "O", "S", "P") and a.formal_charge >= 0:
                return 2  # lone pair in the ring plane
            if a.symbol == "C" and a.formal_charge == -1:
                return 2
            if a.symbol == "C" and a.formal_charge == 1:
                return 0
            return None  # saturated carbon → ring is not aromatic

        for _ in range(len(self.rings) + 1):
            changed = False
            for ring in self.rings:
                if len(ring) < 5 or len(ring) > 7:
                    continue
                if all(self.atoms[a].is_aromatic for a in ring):
                    continue
                contribs = [contribution(a) for a in ring]
                if any(c is None for c in contribs):
                    continue
                if sum(contribs) % 4 != 2:
                    continue
                for a in ring:
                    if not self.atoms[a].is_aromatic:
                        self.atoms[a].is_aromatic = True
                        changed = True
                for k in range(len(ring)):
                    b = self.GetBondBetweenAtoms(ring[k],
                                                 ring[(k + 1) % len(ring)])
                    if b is not None and not b.is_aromatic:
                        b.is_aromatic = True
                        changed = True
            if not changed:
                break

    def _degree_sum(self, atom: Atom) -> float:
        s = 0.0
        for bidx in self.adjacency[atom.idx]:
            # implicit-H valence counts the KEKULÉ order when the input
            # provided one (aromatized Kekulé rings keep exact orders —
            # RDKit also assigns Hs on the Kekulé structure); 1.5 only for
            # bonds WRITTEN aromatic (lowercase / ':' input)
            s += BOND_ORDER_VALUE[self.bonds[bidx].order]
        return s

    def _perceive_implicit_hs(self) -> None:
        import math

        for a in self.atoms:
            if a.explicit_hs is not None:
                a.implicit_hs = 0
                continue
            valences = DEFAULT_VALENCES.get(a.symbol)
            if valences is None:
                a.implicit_hs = 0
                continue
            # effective default valence shifts with formal charge the way
            # Daylight does for N+/O- etc.
            deg = math.ceil(self._degree_sum(a))
            charge = a.formal_charge
            best = 0
            if a.is_aromatic:
                # aromatic atoms never promote to a higher valence state for
                # implicit Hs (Daylight: substituted aromatic n has 0 H —
                # pyrrole-type N must write [nH] explicitly)
                valences = valences[:1]
            for v in valences:
                v_eff = v + charge if a.symbol in ("N", "P", "B") else v - abs(charge)
                if a.symbol in ("O", "S") and charge > 0:
                    v_eff = v + charge
                if deg <= v_eff:
                    best = v_eff - deg
                    break
            a.implicit_hs = max(0, best)

    def _perceive_hybridization(self) -> None:
        for a in self.atoms:
            if a.atomic_num == 0:
                a.hybridization = HYB_UNSPECIFIED
                continue
            n_double = 0
            n_triple = 0
            for bidx in self.adjacency[a.idx]:
                b = self.bonds[bidx]
                if b.is_aromatic:
                    n_double += 1  # approx: aromatic counts toward sp2
                elif b.order == BOND_DOUBLE:
                    n_double += 1
                elif b.order == BOND_TRIPLE:
                    n_triple += 1
            degree = len(self.adjacency[a.idx])
            total_connections = degree + a.GetTotalNumHs()
            if a.is_aromatic:
                a.hybridization = HYB_SP2
            elif n_triple >= 1 or n_double >= 2:
                a.hybridization = HYB_SP
            elif n_double == 1:
                a.hybridization = HYB_SP2
            elif total_connections == 0:
                a.hybridization = HYB_S
            elif total_connections + self._lone_pairs(a) > 4:
                a.hybridization = HYB_SP3D if total_connections + self._lone_pairs(a) == 5 else HYB_SP3D2
            else:
                a.hybridization = HYB_SP3

    def _lone_pairs(self, a: Atom) -> int:
        group_electrons = {
            "C": 4, "N": 5, "O": 6, "F": 7, "Cl": 7, "Br": 7, "I": 7,
            "S": 6, "P": 5, "B": 3, "Si": 4,
        }.get(a.symbol)
        if group_electrons is None:
            return 0
        bonds_e = int(self._degree_sum(a)) + a.GetTotalNumHs()
        return max(0, (group_electrons - a.formal_charge - bonds_e)) // 2

    def _perceive_conjugation(self) -> None:
        """RDKit-semantics conjugation (pairwise rule): a MULTIPLE/aromatic
        bond is conjugated when either end sees another π source through a
        different bond (a second multiple bond, or a N/O/S lone-pair donor
        across a single bond — so an ISOLATED C=C is NOT conjugated, but a
        carbonyl next to an -OH is); a SINGLE bond is conjugated when both
        ends independently carry π (a multiple bond elsewhere, or the atom
        itself is a lone-pair donor) — the butadiene central bond, amide
        C–N, aryl–NH₂."""

        def is_donor(i: int) -> bool:
            a = self.atoms[i]
            return a.symbol in ("N", "O", "S") and self._lone_pairs(a) > 0

        def other_multiple(i: int, excl: int) -> bool:
            for bidx in self.adjacency[i]:
                b2 = self.bonds[bidx]
                if b2.idx == excl:
                    continue
                if b2.is_aromatic or b2.order in (BOND_DOUBLE, BOND_TRIPLE):
                    return True
            return False

        def sees_pi_source(i: int, excl: int) -> bool:
            """A second π system visible from atom i, not via bond ``excl``:
            another multiple bond at i, a lone-pair donor one single bond
            away, or a multiple bond one single bond away (butadiene)."""
            for bidx in self.adjacency[i]:
                b2 = self.bonds[bidx]
                if b2.idx == excl:
                    continue
                if b2.is_aromatic or b2.order in (BOND_DOUBLE, BOND_TRIPLE):
                    return True
                j = b2.end if b2.begin == i else b2.begin
                if is_donor(j) or other_multiple(j, b2.idx):
                    return True
            return False

        for b in self.bonds:
            if b.is_aromatic:
                b.is_conjugated = True
            elif b.order in (BOND_DOUBLE, BOND_TRIPLE):
                b.is_conjugated = (sees_pi_source(b.begin, b.idx)
                                   or sees_pi_source(b.end, b.idx))
            else:
                pi_b = is_donor(b.begin) or other_multiple(b.begin, b.idx)
                pi_e = is_donor(b.end) or other_multiple(b.end, b.idx)
                b.is_conjugated = bool(pi_b and pi_e)

    def _perceive_bond_stereo(self) -> None:
        """Double-bond E/Z from SMILES directional bonds (RDKit
        AssignStereochemistry analog). For C(=C) with one '/' or '\\'
        neighbor bond on each side: normalize each direction to the sense
        seen FROM the double-bond atom; opposite senses → trans → STEREOE,
        same → cis → STEREOZ. (RDKit ranks stereo atoms by CIP; here the
        directional-marked neighbors ARE the stereo atoms — identical for
        the common one-marker-per-side SMILES.)"""

        def sense(u: int, excl: int):
            for bidx in self.adjacency[u]:
                b2 = self.bonds[bidx]
                if b2.idx == excl or b2.direction == DIR_NONE:
                    continue
                s = 1 if b2.direction == DIR_ENDUPRIGHT else -1
                # direction is written for begin→end; flip when u is the end
                return s if b2.begin == u else -s
            return None

        for b in self.bonds:
            if b.order != BOND_DOUBLE or b.is_aromatic or b.in_ring:
                continue
            s_b = sense(b.begin, b.idx)
            s_e = sense(b.end, b.idx)
            if s_b is None or s_e is None:
                continue
            b.stereo = STEREO_E if s_b != s_e else STEREO_Z

    # -- explicit hydrogens -------------------------------------------------
    def add_hs(self) -> "Molecule":
        """Return a copy with implicit hydrogens materialized as graph atoms,
        appended after the heavy atoms in parent-atom order (RDKit AddHs
        layout). After this, GetTotalNumHs()/GetImplicitValence() are 0 for
        every atom and GetDegree() counts H neighbors — matching RDKit
        semantics on an AddHs'd mol (the reference featurizes such mols:
        fragnet/dataset/fragments.py:41-44 then data.py:360-364)."""
        out = Molecule()
        h_counts = []
        for a in self.atoms:
            h_counts.append(a.GetTotalNumHs())
            na = Atom(
                symbol=a.symbol,
                formal_charge=a.formal_charge,
                explicit_hs=0,
                is_aromatic=a.is_aromatic,
                chiral_tag=a.chiral_tag,
                isotope=a.isotope,
                n_radical_electrons=a.n_radical_electrons,
            )
            out.add_atom(na)
        for b in self.bonds:
            out.add_bond(b.begin, b.end, b.order, b.is_aromatic, b.direction)
        for parent, hc in enumerate(h_counts):
            for _ in range(hc):
                h = out.add_atom(Atom(symbol="H", explicit_hs=0))
                out.add_bond(parent, h, BOND_SINGLE)
        out.finalize()
        # H atoms are unhybridized in RDKit
        for a in out.atoms:
            if a.symbol == "H":
                a.hybridization = HYB_S
        return out

    # -- connected components (RDKit GetMolFrags equivalent) ---------------
    def connected_components(self) -> List[Tuple[int, ...]]:
        n = len(self.atoms)
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
                for v in self.neighbors(u):
                    if not seen[v]:
                        seen[v] = True
                        stack.append(v)
            comps.append(tuple(sorted(comp)))
        return comps
