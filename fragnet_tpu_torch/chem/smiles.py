"""Pure-Python SMILES parser and writer for the minichem engine.

Covers the SMILES subset used by the MoleculeNet / UniMol / DTA / CDRP
pipelines of the reference (fragnet/dataset/*): organic subset and bracket
atoms, charges, isotopes, explicit H counts, @/@@ chirality, -=#:$ bonds,
aromatic lowercase atoms, branches, ring closures (incl. %nn and bond orders
on closures), dot-separated components, and /\\ directional bonds.

The writer produces deterministic canonical SMILES via Morgan-style iterative
refinement — used for deduplication and scaffold splits (reference:
fragnet/dataset/splitters_molebert.py uses RDKit canonical smiles; ours is a
self-consistent canonical form, not byte-identical to RDKit's).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from fragnet_tpu_torch.chem.mol import (
    BOND_AROMATIC,
    BOND_DOUBLE,
    BOND_SINGLE,
    BOND_TRIPLE,
    CHI_TETRAHEDRAL_CCW,
    CHI_TETRAHEDRAL_CW,
    CHI_UNSPECIFIED,
    DIR_ENDDOWNRIGHT,
    DIR_ENDUPRIGHT,
    DIR_NONE,
    ORGANIC_SUBSET,
    PERIODIC_TABLE,
    Atom,
    Molecule,
)


class SmilesError(ValueError):
    pass


_TWO_LETTER = ("Cl", "Br")
_AROMATIC_ORGANIC = {"b": "B", "c": "C", "n": "N", "o": "O", "p": "P", "s": "S"}


def MolFromSmiles(smiles: str) -> Optional[Molecule]:
    """Parse SMILES into a Molecule; returns None on failure (RDKit-style)."""
    try:
        return _parse(smiles)
    except SmilesError:
        return None


def _parse(smiles: str) -> Molecule:
    mol = Molecule()
    if not smiles:
        raise SmilesError("empty SMILES")

    prev_atom: Optional[int] = None
    pending_bond: Optional[str] = None
    pending_aromatic = False
    pending_dir = DIR_NONE
    stack: List[Tuple[Optional[int], None]] = []
    # ring closure registry: number -> (atom idx, bond symbol or None, dir)
    ring_open: Dict[int, Tuple[int, Optional[str], str]] = {}
    # written neighbor order per atom (OpenSMILES chirality accounting:
    # preceding atom, then the in-bracket H (-1), then ring digits and
    # subsequent neighbors in written order). Ring digits reserve a slot at
    # the position the digit appears; it is filled when the ring closes.
    nbr_order: List[list] = []

    i = 0
    n = len(smiles)

    def attach(new_idx: int) -> None:
        nonlocal prev_atom, pending_bond, pending_aromatic, pending_dir
        while len(nbr_order) <= new_idx:
            nbr_order.append([])
        if prev_atom is not None:
            order, arom = _resolve_bond(
                pending_bond, pending_aromatic,
                mol.atoms[prev_atom], mol.atoms[new_idx],
            )
            mol.add_bond(prev_atom, new_idx, order, arom, pending_dir)
            nbr_order[new_idx].append(prev_atom)
            nbr_order[prev_atom].append(new_idx)
        a = mol.atoms[new_idx]
        if a.chiral_tag != CHI_UNSPECIFIED and (a.explicit_hs or 0) >= 1:
            nbr_order[new_idx].append(-1)
        prev_atom = new_idx
        pending_bond = None
        pending_aromatic = False
        pending_dir = DIR_NONE

    while i < n:
        ch = smiles[i]

        if ch == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesError(f"unclosed bracket at {i}")
            atom = _parse_bracket_atom(smiles[i + 1 : j])
            idx = mol.add_atom(atom)
            attach(idx)
            i = j + 1
        elif smiles[i : i + 2] in _TWO_LETTER:
            idx = mol.add_atom(Atom(symbol=smiles[i : i + 2]))
            attach(idx)
            i += 2
        elif ch in "BCNOPSFI":
            idx = mol.add_atom(Atom(symbol=ch))
            attach(idx)
            i += 1
        elif ch in "bcnops":
            idx = mol.add_atom(Atom(symbol=_AROMATIC_ORGANIC[ch], is_aromatic=True))
            attach(idx)
            i += 1
        elif ch == "*":
            idx = mol.add_atom(Atom(symbol="*"))
            attach(idx)
            i += 1
        elif ch in "-=#:$":
            pending_bond = ch
            i += 1
        elif ch == "/":
            pending_bond = "-"
            pending_dir = DIR_ENDUPRIGHT
            i += 1
        elif ch == "\\":
            pending_bond = "-"
            pending_dir = DIR_ENDDOWNRIGHT
            i += 1
        elif ch == "(":
            stack.append((prev_atom, None))
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError("unbalanced parentheses")
            prev_atom, _ = stack.pop()
            i += 1
        elif ch == ".":
            prev_atom = None
            pending_bond = None
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                if i + 2 >= n or not smiles[i + 1 : i + 3].isdigit():
                    raise SmilesError(f"bad %ring at {i}")
                num = int(smiles[i + 1 : i + 3])
                i += 3
            else:
                num = int(ch)
                i += 1
            if prev_atom is None:
                raise SmilesError("ring closure before any atom")
            if num in ring_open:
                open_atom, open_bond, open_dir = ring_open.pop(num)
                bond_sym = pending_bond or open_bond
                direction = pending_dir if pending_dir != DIR_NONE else open_dir
                order, arom = _resolve_bond(
                    bond_sym, False, mol.atoms[open_atom], mol.atoms[prev_atom]
                )
                if open_atom == prev_atom:
                    raise SmilesError("ring closure to self")
                mol.add_bond(open_atom, prev_atom, order, arom, direction)
                slot = nbr_order[open_atom].index(("r", num))
                nbr_order[open_atom][slot] = prev_atom
                nbr_order[prev_atom].append(open_atom)
                pending_bond = None
                pending_dir = DIR_NONE
            else:
                ring_open[num] = (prev_atom, pending_bond, pending_dir)
                nbr_order[prev_atom].append(("r", num))
                pending_bond = None
                pending_dir = DIR_NONE
        elif ch in " \t":
            break  # SMILES followed by a title/whitespace — stop
        else:
            raise SmilesError(f"unexpected character {ch!r} at {i}")

    if stack:
        raise SmilesError("unbalanced parentheses at end")
    if ring_open:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_open)}")
    if not mol.atoms:
        raise SmilesError("no atoms parsed")
    for idx, order in enumerate(nbr_order):
        if mol.atoms[idx].chiral_tag != CHI_UNSPECIFIED:
            mol.atoms[idx].parse_nbr_order = list(order)
    return mol.finalize()


def _resolve_bond(sym: Optional[str], arom_flag: bool, a1: Atom, a2: Atom):
    if sym is None:
        if (a1.is_aromatic and a2.is_aromatic) or arom_flag:
            return BOND_AROMATIC, True
        return BOND_SINGLE, False
    if sym == "-":
        return BOND_SINGLE, False
    if sym == "=":
        return BOND_DOUBLE, False
    if sym == "#":
        return BOND_TRIPLE, False
    if sym == ":":
        return BOND_AROMATIC, True
    if sym == "$":
        raise SmilesError("quadruple bonds unsupported")
    raise SmilesError(f"unknown bond symbol {sym}")


def _parse_bracket_atom(body: str) -> Atom:
    """Parse the inside of a bracket atom: isotope? symbol chiral? H-count?
    charge? class? — e.g. ``13CH3+``, ``nH``, ``O-``, ``C@@H``."""
    if not body:
        raise SmilesError("empty bracket atom")
    i = 0
    n = len(body)

    isotope = 0
    while i < n and body[i].isdigit():
        isotope = isotope * 10 + int(body[i])
        i += 1

    aromatic = False
    symbol = None
    if i < n and body[i : i + 2] in PERIODIC_TABLE and body[i : i + 2] not in ("H",):
        # two-letter element (Cl, Br, Se, Si, Na, ...)
        cand = body[i : i + 2]
        if cand[1].islower() and cand in PERIODIC_TABLE:
            symbol = cand
            i += 2
    if symbol is None and i < n:
        c = body[i]
        if c in _AROMATIC_ORGANIC or c in ("a",):
            symbol = _AROMATIC_ORGANIC.get(c, "C")
            aromatic = True
            i += 1
        elif c == "*":
            symbol = "*"
            i += 1
        elif c.isupper():
            symbol = c
            i += 1
        elif c == "s" or c.islower():
            symbol = c.upper()
            aromatic = True
            i += 1
    if symbol is None:
        raise SmilesError(f"cannot read element in bracket {body!r}")

    chiral = CHI_UNSPECIFIED
    if i < n and body[i] == "@":
        if i + 1 < n and body[i + 1] == "@":
            chiral = CHI_TETRAHEDRAL_CW
            i += 2
        else:
            chiral = CHI_TETRAHEDRAL_CCW
            i += 1
        # @TH1 style annotations — skip letters+digits
        while i < n and body[i].isalpha() and body[i] == "T":
            i += 2  # TH
            while i < n and body[i].isdigit():
                i += 1

    hcount = 0
    has_h = False
    if i < n and body[i] == "H":
        has_h = True
        hcount = 1
        i += 1
        if i < n and body[i].isdigit():
            hcount = int(body[i])
            i += 1

    charge = 0
    while i < n and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        if i < n and body[i].isdigit():
            charge += sign * int(body[i])
            i += 1
        else:
            charge += sign

    if i < n and body[i] == ":":
        i += 1
        while i < n and body[i].isdigit():
            i += 1  # atom-map class, ignored

    if i != n:
        raise SmilesError(f"trailing characters in bracket {body!r}")

    return Atom(
        symbol=symbol,
        is_aromatic=aromatic,
        formal_charge=charge,
        explicit_hs=hcount if (has_h or True) else None,  # bracket atoms fix H count
        chiral_tag=chiral,
        isotope=isotope,
    )


# ---------------------------------------------------------------------------
# Canonical SMILES writer (Morgan-style canonical ranking)
# ---------------------------------------------------------------------------

def _initial_invariant(mol: Molecule, a: Atom) -> Tuple:
    return (
        a.atomic_num,
        a.GetDegree(),
        a.formal_charge,
        a.GetTotalNumHs(),
        int(a.is_aromatic),
        int(a.in_ring),
        a.isotope,
    )


def canonical_ranks(mol: Molecule) -> List[int]:
    """Deterministic canonical atom ranks via iterative neighborhood refinement."""
    n = mol.GetNumAtoms()
    inv = [_initial_invariant(mol, a) for a in mol.atoms]
    ranks = _ranks_from_keys(inv)
    for _ in range(n):
        keys = []
        for i in range(n):
            nb = sorted(
                (ranks[v], mol.GetBondBetweenAtoms(i, v).GetBondTypeAsDouble())
                for v in mol.neighbors(i)
            )
            keys.append((ranks[i], tuple(nb)))
        new_ranks = _ranks_from_keys(keys)
        if new_ranks == ranks:
            break
        ranks = new_ranks
    # tie-break deterministically by atom index to get a full ordering
    order = sorted(range(n), key=lambda i: (ranks[i], i))
    final = [0] * n
    for r, i in enumerate(order):
        final[i] = r
    return final


def _ranks_from_keys(keys: List) -> List[int]:
    sorted_unique = {k: r for r, k in enumerate(sorted(set(keys)))}
    return [sorted_unique[k] for k in keys]


def MolToSmiles(mol: Molecule, canonical: bool = True) -> str:
    """Write SMILES. Canonical = start DFS at the lowest-rank atom of each
    component and visit neighbors in rank order. Two passes: classify
    tree/ring-closure bonds first, then emit (ring digits must sit directly
    after the atom token, so late-discovered back edges need the pre-pass)."""
    n = mol.GetNumAtoms()
    if n == 0:
        return ""
    ranks = canonical_ranks(mol) if canonical else list(range(n))

    def nb_sorted(u: int) -> List[int]:
        return sorted(
            mol.adjacency[u],
            key=lambda bi: (
                ranks[mol.bonds[bi].end if mol.bonds[bi].begin == u else mol.bonds[bi].begin],
                bi,
            ),
        )

    # ---- pass 1: DFS to classify tree vs ring-closure bonds --------------
    visited = [False] * n
    tree_children: Dict[int, List[Tuple[int, int]]] = {i: [] for i in range(n)}
    ring_bonds_at: Dict[int, List[int]] = {i: [] for i in range(n)}
    ring_closure_bonds: List[int] = []
    roots: List[int] = []

    comps = mol.connected_components()
    for comp in sorted(comps, key=lambda c: min(ranks[i] for i in c)):
        start = min(comp, key=lambda i: (ranks[i], i))
        roots.append(start)
        stack = [(start, -1)]
        visited[start] = True
        seen_bonds: set = set()
        # iterative DFS preserving neighbor order
        def expand(u: int) -> None:
            for bi in nb_sorted(u):
                if bi in seen_bonds:
                    continue
                b = mol.bonds[bi]
                v = b.end if b.begin == u else b.begin
                if visited[v]:
                    seen_bonds.add(bi)
                    ring_closure_bonds.append(bi)
                    ring_bonds_at[u].append(bi)
                    ring_bonds_at[v].append(bi)
                else:
                    seen_bonds.add(bi)
                    visited[v] = True
                    tree_children[u].append((bi, v))
                    expand(v)

        expand(start)

    ring_num: Dict[int, int] = {bi: k + 1 for k, bi in enumerate(ring_closure_bonds)}

    def bond_symbol(b) -> str:
        t = b.GetBondType()
        if t == BOND_DOUBLE:
            return "="
        if t == BOND_TRIPLE:
            return "#"
        return ""  # single & aromatic implicit

    def _perm_parity(src: list, dst: list) -> int:
        """Parity (0 even / 1 odd) of the permutation taking ``src`` to
        ``dst`` (equal multisets of distinct items)."""
        pos = {v: i for i, v in enumerate(src)}
        perm = [pos[v] for v in dst]
        inv = sum(
            1
            for i in range(len(perm))
            for j in range(i + 1, len(perm))
            if perm[i] > perm[j]
        )
        return inv % 2

    def out_chiral_tag(a: Atom, u: int, parent: Optional[int]) -> str:
        """@/@@ recomputed for the OUTPUT neighbor order (OpenSMILES: the
        written tag's handedness is relative to the listing order — parent,
        in-bracket H, then ring digits and children as emitted). If the
        parse-time order is unavailable or the neighbor sets differ (e.g.
        scaffold extraction removed substituents), the tag is kept verbatim
        (best-effort)."""
        tag = a.chiral_tag
        if a.parse_nbr_order is None:
            return tag
        out_order: list = [] if parent is None else [parent]
        if a.GetTotalNumHs() >= 1:
            out_order.append(-1)
        for bi in ring_bonds_at[u]:
            b = mol.bonds[bi]
            out_order.append(b.end if b.begin == u else b.begin)
        out_order.extend(v for _, v in tree_children[u])
        if sorted(map(str, a.parse_nbr_order)) != sorted(map(str, out_order)):
            return tag
        if _perm_parity(a.parse_nbr_order, out_order):
            return (CHI_TETRAHEDRAL_CW if tag == CHI_TETRAHEDRAL_CCW
                    else CHI_TETRAHEDRAL_CCW)
        return tag

    def atom_token(a: Atom, u: int, parent: Optional[int]) -> str:
        needs_brackets = (
            a.symbol not in ORGANIC_SUBSET
            or a.formal_charge != 0
            or a.isotope
            or a.chiral_tag != CHI_UNSPECIFIED
            or (a.explicit_hs is not None and a.symbol not in ORGANIC_SUBSET)
            or (a.symbol == "H")
        )
        sym = a.symbol.lower() if a.is_aromatic and a.symbol in ("B", "C", "N", "O", "P", "S") else a.symbol
        if a.is_aromatic and a.symbol == "N" and a.GetTotalNumHs() > 0:
            needs_brackets = True  # [nH]
        if not needs_brackets:
            return sym
        body = ""
        if a.isotope:
            body += str(a.isotope)
        body += sym
        tag = out_chiral_tag(a, u, parent) if a.chiral_tag != CHI_UNSPECIFIED \
            else a.chiral_tag
        if tag == CHI_TETRAHEDRAL_CCW:
            body += "@"
        elif tag == CHI_TETRAHEDRAL_CW:
            body += "@@"
        hs = a.GetTotalNumHs()
        if hs == 1:
            body += "H"
        elif hs > 1:
            body += f"H{hs}"
        if a.formal_charge > 0:
            body += "+" if a.formal_charge == 1 else f"+{a.formal_charge}"
        elif a.formal_charge < 0:
            body += "-" if a.formal_charge == -1 else f"-{-a.formal_charge}"
        return f"[{body}]"

    # ---- pass 2: emit -----------------------------------------------------
    def write(u: int, parent: Optional[int] = None) -> str:
        a = mol.atoms[u]
        out = [atom_token(a, u, parent)]
        for bi in ring_bonds_at[u]:
            b = mol.bonds[bi]
            num = ring_num[bi]
            out.append(bond_symbol(b) + (str(num) if num < 10 else f"%{num:02d}"))
        children = tree_children[u]
        for k, (bi, v) in enumerate(children):
            b = mol.bonds[bi]
            sub = bond_symbol(b) + write(v, u)
            out.append(f"({sub})" if k < len(children) - 1 else sub)
        return "".join(out)

    parts = [write(r) for r in roots]
    return ".".join(parts)


def canonical_smiles(smiles: str) -> Optional[str]:
    mol = MolFromSmiles(smiles)
    if mol is None:
        return None
    return MolToSmiles(mol)
