"""One-hot feature stack — numerically identical layout to the reference
production feature set (``exp``/``exp1s``), fragnet/dataset/features.py:7-162.

Atom features (167 dims): atomic number 1..118 one-hot-unk (118) + degree
0..10 (11) + implicit valence 0..6 unk (7) + formal charge -5..5 unk (11) +
radical electrons 0..4 unk (5) + hybridization 7-way unk (7) + aromatic (2) +
in-ring (2) + chiral tag 3-way unk (3) + total num Hs as a count (1).

Bond features (17 dims): type SINGLE/DOUBLE/TRIPLE/AROMATIC (4) + conjugated
(2) + in-ring (2) + stereo ANY/Z/E/NONE unk (4) + bond dir 5-way unk (5).

Connection features (6 dims): 4 bond types + self_cn + iso_cn3.

Works with both minichem objects and RDKit objects: accessors are duck-typed
and enum values are compared via ``str()`` normalization.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def one_of_k_encoding(x, allowable_set):
    """Reference: fragnet/dataset/feature_utils.py:150-153 — raises on unknown."""
    if x not in allowable_set:
        raise ValueError(f"input {x} not in allowable set {allowable_set}")
    return [x == s for s in allowable_set]


def one_of_k_encoding_unk(x, allowable_set):
    """Reference: feature_utils.py:156-160 — unknown maps to the last element."""
    if x not in allowable_set:
        x = allowable_set[-1]
    return [x == s for s in allowable_set]


def _enum_str(v) -> str:
    """Normalize rdkit enums / minichem strings to a bare string name."""
    s = str(v)
    return s.rsplit(".", 1)[-1]


_HYB_SET = ["S", "SP", "SP2", "SP3", "SP3D", "SP3D2", "UNSPECIFIED"]
_CHI_SET = ["CHI_TETRAHEDRAL_CW", "CHI_TETRAHEDRAL_CCW", "CHI_UNSPECIFIED"]
_STEREO_SET = ["STEREOANY", "STEREOZ", "STEREOE", "STEREONONE"]
_DIR_SET = ["BEGINWEDGE", "BEGINDASH", "ENDDOWNRIGHT", "ENDUPRIGHT", "NONE"]
_BT_SET = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"]

ATOM_FDIM = 167
BOND_FDIM = 17
CONNECTION_FDIM = 6


def get_bond_pair(mol, add_self_loops: bool = False):
    """Directed edge index: two directed edges per bond in bond order.
    Reference: feature_utils.py:285-296."""
    res = [[], []]
    for bond in mol.GetBonds():
        res[0] += [bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()]
        res[1] += [bond.GetEndAtomIdx(), bond.GetBeginAtomIdx()]
    if add_self_loops:
        res[0] += list(range(mol.GetNumAtoms()))
        res[1] += list(range(mol.GetNumAtoms()))
    return res


class FeaturesEXP:
    """Production feature creator (data types ``exp``/``exp1s``)."""

    def __init__(self, add_connection_chrl: bool = False):
        self.atom_list_one_hot = list(range(1, 119))
        self.use_bond_chirality = True
        self.add_connection_chrl = add_connection_chrl

    # -- atoms -------------------------------------------------------------
    def atom_features_one_hot(self, atom) -> np.ndarray:
        atom_type = one_of_k_encoding_unk(atom.GetAtomicNum(), self.atom_list_one_hot)
        degree = one_of_k_encoding(atom.GetDegree(), [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
        valence = one_of_k_encoding_unk(atom.GetImplicitValence(), [0, 1, 2, 3, 4, 5, 6])
        charge = one_of_k_encoding_unk(
            atom.GetFormalCharge(), [-5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5]
        )
        rad_elec = one_of_k_encoding_unk(atom.GetNumRadicalElectrons(), [0, 1, 2, 3, 4])
        hyb = one_of_k_encoding_unk(_enum_str(atom.GetHybridization()), _HYB_SET)
        arom = one_of_k_encoding(bool(atom.GetIsAromatic()), [False, True])
        atom_ring = one_of_k_encoding(bool(atom.IsInRing()), [False, True])
        chiral = one_of_k_encoding_unk(_enum_str(atom.GetChiralTag()), _CHI_SET)
        numhs = [atom.GetTotalNumHs()]
        return np.array(
            atom_type + degree + valence + charge + rad_elec + hyb + arom
            + atom_ring + chiral + numhs
        )

    # -- bonds -------------------------------------------------------------
    def bond_features_one_hot(self, bond, use_chirality: bool = True) -> List:
        bt = _enum_str(bond.GetBondType())
        bond_feats = [bt == "SINGLE", bt == "DOUBLE", bt == "TRIPLE", bt == "AROMATIC"]
        conj = one_of_k_encoding(bool(bond.GetIsConjugated()), [False, True])
        inring = one_of_k_encoding(bool(bond.IsInRing()), [False, True])
        bond_feats = bond_feats + conj + inring
        if use_chirality:
            bond_feats = bond_feats + one_of_k_encoding_unk(
                _enum_str(bond.GetStereo()), _STEREO_SET
            )
        bond_feats = bond_feats + one_of_k_encoding_unk(
            _enum_str(bond.GetBondDir()), _DIR_SET
        )
        return list(bond_feats)

    # -- fragment connections ---------------------------------------------
    def connection_features_one_hot(self, connection) -> List:
        bt = connection.bond_type
        bts = _enum_str(bt) if not isinstance(bt, str) else bt
        bond_feats = [
            bts == "SINGLE",
            bts == "DOUBLE",
            bts == "TRIPLE",
            bts == "AROMATIC",
            bts == "self_cn",
            bts == "iso_cn3",
        ]
        if self.add_connection_chrl:
            bond = connection.bond
            conj = one_of_k_encoding(bool(bond.GetIsConjugated()), [False, True])
            inring = one_of_k_encoding(bool(bond.IsInRing()), [False, True])
            bond_feats = bond_feats + conj + inring
            bond_feats = bond_feats + one_of_k_encoding_unk(
                _enum_str(bond.GetStereo()), _STEREO_SET
            )
            bond_feats = bond_feats + one_of_k_encoding_unk(
                _enum_str(bond.GetBondDir()), _DIR_SET
            )
        return list(bond_feats)

    # -- whole-molecule ----------------------------------------------------
    def get_atom_and_bond_features_atom_graph_one_hot(self, mol, use_chirality: bool):
        """Atom features, directed edge index, per-directed-edge bond features.
        Reference: features.py:19-37."""
        edge_index = get_bond_pair(mol, add_self_loops=False)
        node_f = [self.atom_features_one_hot(atom) for atom in mol.GetAtoms()]
        edge_attr = []
        for bond in mol.GetBonds():
            bf = self.bond_features_one_hot(bond, use_chirality=use_chirality)
            edge_attr.append(bf)
            edge_attr.append(bf)
        return node_f, edge_index, edge_attr


# ---------------------------------------------------------------------------
# legacy 13-symbol feature set (data types ``exp0`` / ``exp01s``)
# ---------------------------------------------------------------------------

# atomic number → symbol for the legacy symbol list (minichem atoms expose
# GetAtomicNum but not GetSymbol; RDKit atoms are used directly when present)
_NUM_TO_SYMBOL = {
    35: "Br", 6: "C", 17: "Cl", 9: "F", 1: "H", 53: "I", 19: "K",
    7: "N", 11: "Na", 8: "O", 15: "P", 16: "S",
}

_HYB_SET0 = ["SP", "SP2", "SP3", "SP3D", "SP3D2", "UNSPECIFIED"]

ATOM_FDIM0 = 38
BOND_FDIM0 = 11


class FeaturesEXP0:
    """Legacy feature creator (data types ``exp0``/``exp01s``) — the
    13-symbol stack of reference fragnet/dataset/features0.py:7-160.

    Atom features (38 dims): symbol 13-way unk (13) + degree 0..6 strict (7)
    + implicit valence 0..6 unk (7) + formal charge (1) + radical electrons
    (1) + hybridization 6-way unk (6) + aromatic (1) + in-ring (1) + total
    num Hs (1). The reference's optional use_chirality tail
    (features0.py:102-111) is off by default, matching its call sites.

    Bond features (11 dims): type S/D/T/AROM (4) + conjugated (1) + in-ring
    (1) + bond dir 5-way unk (5). ``use_bond_chirality`` is False
    (features0.py:25), so the stereo block (features0.py:129-132) is not
    emitted — same as every reference exp0 run.

    Connection features: identical 6-dim block (features0.py:147-160).
    """

    def __init__(self):
        self.atom_list_one_hot = [
            "Br", "C", "Cl", "F", "H", "I", "K", "N", "Na", "O", "P", "S",
            "Unknown",
        ]
        self.use_bond_chirality = False

    @staticmethod
    def _symbol(atom) -> str:
        get = getattr(atom, "GetSymbol", None)
        if get is not None:
            return get()
        return _NUM_TO_SYMBOL.get(atom.GetAtomicNum(), "Unknown")

    # -- atoms -------------------------------------------------------------
    def atom_features_one_hot(self, atom, use_chirality: bool = False) -> np.ndarray:
        atom_type = one_of_k_encoding_unk(self._symbol(atom), self.atom_list_one_hot)
        degree = one_of_k_encoding(atom.GetDegree(), [0, 1, 2, 3, 4, 5, 6])
        valence = one_of_k_encoding_unk(atom.GetImplicitValence(), [0, 1, 2, 3, 4, 5, 6])
        charge = [atom.GetFormalCharge()]
        rad_elec = [atom.GetNumRadicalElectrons()]
        hyb = one_of_k_encoding_unk(_enum_str(atom.GetHybridization()), _HYB_SET0)
        arom = [bool(atom.GetIsAromatic())]
        atom_ring = [bool(atom.IsInRing())]
        numhs = [atom.GetTotalNumHs()]
        results = (atom_type + degree + valence + charge + rad_elec + hyb
                   + arom + atom_ring + numhs)
        if use_chirality:
            # reference features0.py:102-111 (CIP code via atom property;
            # minichem exposes no _CIPCode property → unknown branch)
            has_prop = getattr(atom, "HasProp", None)
            get_prop = getattr(atom, "GetProp", None)
            try:
                cip = one_of_k_encoding_unk(get_prop("_CIPCode"), ["R", "S"])
            except Exception:
                cip = [False, False]
            possible = bool(has_prop("_ChiralityPossible")) if has_prop else False
            results = results + cip + [possible]
        return np.array(results)

    # -- bonds -------------------------------------------------------------
    def bond_features_one_hot(self, bond, use_chirality: bool = True) -> List:
        bt = _enum_str(bond.GetBondType())
        bond_feats = [
            bt == "SINGLE", bt == "DOUBLE", bt == "TRIPLE", bt == "AROMATIC",
            bool(bond.GetIsConjugated()), bool(bond.IsInRing()),
        ]
        if use_chirality:
            bond_feats = bond_feats + one_of_k_encoding_unk(
                _enum_str(bond.GetStereo()), _STEREO_SET
            )
        bond_feats = bond_feats + one_of_k_encoding_unk(
            _enum_str(bond.GetBondDir()), _DIR_SET
        )
        return list(bond_feats)

    # -- fragment connections ---------------------------------------------
    def connection_features_one_hot(self, connection) -> List:
        bt = connection.bond_type
        bts = _enum_str(bt) if not isinstance(bt, str) else bt
        return [
            bts == "SINGLE",
            bts == "DOUBLE",
            bts == "TRIPLE",
            bts == "AROMATIC",
            bts == "self_cn",
            bts == "iso_cn3",
        ]

    # -- whole-molecule ----------------------------------------------------
    def get_atom_and_bond_features_atom_graph_one_hot(self, mol, use_chirality: bool):
        """Reference features0.py:27-49 (add_self_loops hardwired False)."""
        edge_index = get_bond_pair(mol, add_self_loops=False)
        node_f = [self.atom_features_one_hot(atom) for atom in mol.GetAtoms()]
        edge_attr = []
        for bond in mol.GetBonds():
            bf = self.bond_features_one_hot(bond, use_chirality=use_chirality)
            edge_attr.append(bf)
            edge_attr.append(bf)
        return node_f, edge_index, edge_attr


def feature_creator_for(data_type: str):
    """Featurizer dispatch by data type — reference data.py:328-337."""
    if data_type in ("exp0", "exp01s"):
        return FeaturesEXP0()
    return FeaturesEXP()
