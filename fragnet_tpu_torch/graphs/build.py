"""Host-side graph construction: molecule → ragged numpy arrays for all four
graph levels.

Replicates the semantics of fragnet/dataset/data.py:343-538 (CreateData) with
TPU-conscious algorithms:
  * the bond-line-graph pair scan is O(E·deg) via incidence maps instead of
    the reference's O(E²) double loop (data.py:116-128), preserving the
    reference's (i-major, j-ascending) edge ordering;
  * output is plain numpy, ready for the static-shape batcher.

Field glossary (reference names kept for auditability):
  x_atoms           (N,167) atom one-hots
  edge_index        (2,E)   directed atom-graph edges, E = 2·n_bonds
  edge_attr         (E,17)  bond features per directed edge
  nf_bonds          (E,17)  bond-graph node features (== edge_attr layout)
  ei_bonds          (2,EB)  bond line graph (share exactly one atom) + the
                            2-atom-component special pairs (data.py:157-182)
  ea_bonds          (EB,1)  cos(angle) at the shared atom; 1.0 for special
  atom_to_frag      (N,)    fragment id per atom
  x_frags           (F,167) summed atom features per fragment
  frag_index        (2,C)   directed fragment connections (exp1s rule:
                            single-fragment mols get ONE self edge,
                            data.py:505-538)
  cnx_attr          (C,6)   connection features per directed connection
  nf_fbonds         (C,6)   fragment-connection line-graph node features
  ei_fbonds         (2,EC)  fconn line graph (share exactly one fragment;
                            2-node special case data.py:136-143)
  ea_fbonds         (EC,6)  sum of the two endpoint connection features
  bnd_lngth/bnd_angl/dh_angl — 3D pretrain targets (data.py:224-260)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from fragnet_tpu_torch import native
from fragnet_tpu_torch.chem.features import FeaturesEXP
from fragnet_tpu_torch.chem.fragments import FragmentedMol


@dataclasses.dataclass
class MolGraph:
    """Ragged per-molecule graph arrays (host-side)."""

    x_atoms: np.ndarray
    edge_index: np.ndarray
    edge_attr: np.ndarray
    nf_bonds: np.ndarray
    ei_bonds: np.ndarray
    ea_bonds: np.ndarray
    atom_to_frag: np.ndarray
    x_frags: np.ndarray
    frag_index: np.ndarray
    cnx_attr: np.ndarray
    nf_fbonds: np.ndarray
    ei_fbonds: np.ndarray
    ea_fbonds: np.ndarray
    y: np.ndarray
    smiles: str = ""
    # optional pretrain targets
    bnd_lngth: Optional[np.ndarray] = None
    bnd_angl: Optional[np.ndarray] = None
    dh_angl: Optional[np.ndarray] = None
    # optional task extras
    protein: Optional[np.ndarray] = None
    gene_expr: Optional[np.ndarray] = None

    @property
    def n_atoms(self) -> int:
        return self.x_atoms.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def n_frags(self) -> int:
        return self.x_frags.shape[0]

    @property
    def n_fconn(self) -> int:
        return self.frag_index.shape[1]

    @property
    def n_bg_edges(self) -> int:
        return self.ei_bonds.shape[1]

    @property
    def n_fc_edges(self) -> int:
        return self.ei_fbonds.shape[1]


def _line_graph_edges(edge_endpoints: List[Tuple[int, int]]) -> Tuple[List[int], List[int]]:
    """Pairs of directed edges sharing exactly ONE atom, in the reference's
    i-major / j-ascending order (data.py:116-128) but O(E·deg). Uses the C++
    native runtime (fragnet_tpu_torch/native) when a compiler is present,
    else ``_line_graph_edges_py``; the two give the same pairs."""
    if edge_endpoints:
        src = np.fromiter((u for u, _ in edge_endpoints), np.int32)
        dst = np.fromiter((v for _, v in edge_endpoints), np.int32)
        out = native.line_graph(src, dst, int(max(src.max(), dst.max())) + 1)
        if out is not None:
            return out[0].tolist(), out[1].tolist()
    return _line_graph_edges_py(edge_endpoints)


def _line_graph_edges_py(edge_endpoints: List[Tuple[int, int]]) -> Tuple[List[int], List[int]]:
    """``_line_graph_edges`` in Python (no native runtime)."""
    incident: Dict[int, List[int]] = {}
    for e, (u, v) in enumerate(edge_endpoints):
        incident.setdefault(u, []).append(e)
        incident.setdefault(v, []).append(e)
    res0, res1 = [], []
    for i, (u, v) in enumerate(edge_endpoints):
        cand = set(incident[u])
        cand.update(incident[v])
        s_i = {u, v}
        # NOTE: (i, i) is kept when the edge is a self-edge (u == v): the
        # reference's double loop includes it (data.py:120-128 via 145-152),
        # which is how single-fragment molecules get their fconn self-loop.
        for j in sorted(cand):
            s_j = set(edge_endpoints[j])
            if len(s_i & s_j) == 1:
                res0.append(i)
                res1.append(j)
    return res0, res1


def _fconn_line_graph(fedges: List[Tuple[int, int]]) -> Tuple[List[int], List[int]]:
    """Line graph over directed fragment connections. Mirrors
    get_bond_pair_fbond_graph (data.py:131-154): with exactly two nodes,
    connect every ordered pair of distinct *lists*; otherwise share-one rule."""
    n = len(fedges)
    res0, res1 = [], []
    if n == 2:
        for i in range(n):
            for j in range(n):
                if list(fedges[i]) != list(fedges[j]):
                    res0.append(i)
                    res1.append(j)
        return res0, res1
    return _line_graph_edges(fedges)


class GraphBuilder:
    """Molecule → MolGraph. data_type: 'exp1s' (production) or 'exp'
    (two-edge rule for single-fragment mols)."""

    def __init__(
        self,
        data_type: str = "exp1s",
        add_dhangles: bool = False,
        feature_creator: Optional[FeaturesEXP] = None,
        compat_reference_targets: bool = False,
    ):
        from fragnet_tpu_torch.chem.features import feature_creator_for

        self.features = feature_creator or feature_creator_for(data_type)
        self.one_s = "1s" in data_type
        self.add_dhangles = add_dhangles
        # replicate the reference's no-axis .sum() collapse in the bond-angle
        # target exactly (data.py:239) for bitwise target parity runs
        self.compat_reference_targets = compat_reference_targets

    # -- fragment level ----------------------------------------------------
    def _frag_idx_cnx_attr(self, graph: FragmentedMol):
        frag_idx = [[], []]
        cnx_attr = []
        single = self.one_s and len(graph.fragments) == 1
        for cn in graph.connections:
            if single:
                frag_idx[0].append(cn.BeginFragIdx)
                frag_idx[1].append(cn.EndFragIdx)
                cnx_attr.append(self.features.connection_features_one_hot(cn))
            else:
                frag_idx[0] += [cn.BeginFragIdx, cn.EndFragIdx]
                frag_idx[1] += [cn.EndFragIdx, cn.BeginFragIdx]
                f = self.features.connection_features_one_hot(cn)
                cnx_attr.append(f)
                cnx_attr.append(f)
        return (
            np.array(frag_idx, dtype=np.int32).reshape(2, -1),
            np.array(cnx_attr, dtype=np.float32).reshape(-1, 6),
        )

    # -- main --------------------------------------------------------------
    def build(
        self,
        mol,
        conf,
        y,
        smiles: str = "",
        frag_type: str = "brics",
        protein: Optional[np.ndarray] = None,
        gene_expr: Optional[np.ndarray] = None,
    ) -> Optional[MolGraph]:
        graph = FragmentedMol(mol, conf, frag_type)

        node_f, edge_index_l, edge_attr_l = (
            self.features.get_atom_and_bond_features_atom_graph_one_hot(
                graph.mol, self.features.use_bond_chirality
            )
        )
        if len(edge_index_l[0]) == 0:
            return None  # no-edge molecules rejected (data.py:368-371)
        if not (len(node_f) == max(edge_index_l[0]) + 1 == max(edge_index_l[1]) + 1):
            return None

        x_atoms = np.asarray(node_f, dtype=np.float32)
        edge_index = np.asarray(edge_index_l, dtype=np.int32)
        edge_attr = np.asarray(edge_attr_l, dtype=np.float32)

        # ---- bond line graph ---------------------------------------------
        endpoints = list(zip(edge_index_l[0], edge_index_l[1]))
        res0, res1 = _line_graph_edges(endpoints)

        # 2-atom connected components: pair the two directed edges
        # (data.py:157-182)
        special_pairs = set()
        endpoint_to_id = {pair: i for i, pair in enumerate(endpoints)}
        for comp in _components(graph.mol):
            if len(comp) == 2:
                a, b = comp
                if (a, b) in endpoint_to_id and (b, a) in endpoint_to_id:
                    i1, i2 = endpoint_to_id[(a, b)], endpoint_to_id[(b, a)]
                    res0 += [i1, i2]
                    res1 += [i2, i1]
                    special_pairs.add((i1, i2))
                    special_pairs.add((i2, i1))

        ei_bonds = np.array([res0, res1], dtype=np.int32).reshape(2, -1)
        # sort by aggregation target (row 0): segment softmax/sum are
        # order-independent, and a dst-major order lets the packed transport
        # (data/packing.py) encode bg_dst as in-degree run lengths
        if ei_bonds.shape[1]:
            order = np.argsort(ei_bonds[0], kind="stable")
            ei_bonds = ei_bonds[:, order]

        # cos(angle) edge attrs
        pos = np.asarray(conf.GetPositions(), dtype=np.float64) if conf is not None else None
        ea_bonds = np.zeros((ei_bonds.shape[1], 1), dtype=np.float32)
        for k in range(ei_bonds.shape[1]):
            n1, n2 = int(ei_bonds[0, k]), int(ei_bonds[1, k])
            if (n1, n2) in special_pairs:
                ea_bonds[k, 0] = 1.0
                continue
            s1, s2 = set(endpoints[n1]), set(endpoints[n2])
            common = (s1 & s2).pop()
            others = list((s1 | s2) - {common})
            if pos is None or len(others) != 2:
                ea_bonds[k, 0] = 0.0
            else:
                ea_bonds[k, 0] = _cos_angle(pos, others[0], common, others[1])

        # ---- fragment level ----------------------------------------------
        atom_to_frag = np.array(
            list(graph.atom_to_frag_id.values()), dtype=np.int32
        )
        n_frags = len(graph.fragments)
        x_frags = np.zeros((n_frags, x_atoms.shape[1]), dtype=np.float32)
        np.add.at(x_frags, atom_to_frag, x_atoms)

        frag_index, cnx_attr = self._frag_idx_cnx_attr(graph)

        # ---- fragment-connection line graph (data.py:263-310) -------------
        keys = [tuple(frag_index[:, i]) for i in range(frag_index.shape[1])]
        attr_by_key = {}
        for i, k in enumerate(keys):
            attr_by_key[k] = cnx_attr[i]
        nf_fbonds = np.array([attr_by_key[k] for k in keys], dtype=np.float32).reshape(-1, 6)
        fres0, fres1 = _fconn_line_graph(keys)
        ei_fbonds = np.array([fres0, fres1], dtype=np.int32).reshape(2, -1)
        ea_fbonds = np.zeros((ei_fbonds.shape[1], 6), dtype=np.float32)
        for k in range(ei_fbonds.shape[1]):
            ea_fbonds[k] = (
                attr_by_key[keys[int(ei_fbonds[0, k])]]
                + attr_by_key[keys[int(ei_fbonds[1, k])]]
            )

        out = MolGraph(
            x_atoms=x_atoms,
            edge_index=edge_index,
            edge_attr=edge_attr,
            nf_bonds=edge_attr.copy(),
            ei_bonds=ei_bonds,
            ea_bonds=ea_bonds,
            atom_to_frag=atom_to_frag,
            x_frags=x_frags,
            frag_index=frag_index,
            cnx_attr=cnx_attr,
            nf_fbonds=nf_fbonds,
            ei_fbonds=ei_fbonds,
            ea_fbonds=ea_fbonds,
            y=np.asarray(y, dtype=np.float32).reshape(-1),
            smiles=smiles,
            protein=protein,
            gene_expr=gene_expr,
        )

        if self.add_dhangles and pos is not None:
            bl, ba, dh = geometric_targets(
                pos, edge_index,
                compat_reference=self.compat_reference_targets)
            out.bnd_lngth = bl.reshape(-1, 1).astype(np.float32)
            out.bnd_angl = ba.reshape(-1, 1).astype(np.float32)
            out.dh_angl = dh.reshape(-1, 1).astype(np.float32)
        return out


def _cos_angle(pos: np.ndarray, i: int, j: int, k: int) -> float:
    v1 = pos[i] - pos[j]
    v2 = pos[k] - pos[j]
    n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
    if n1 < 1e-12 or n2 < 1e-12:
        return 1.0
    return float(np.clip(np.dot(v1, v2) / (n1 * n2), -1.0, 1.0))


def geometric_targets(pos: np.ndarray, edge_index: np.ndarray,
                      compat_reference: bool = False):
    """3D pretraining targets (3D-PGT style, reference data.py:224-260).

    bnd_lngth[e]  = squared length of directed edge e
    bnd_angl[i]   = squared norm of the summed outgoing unit vectors at atom i
    dh_angl[e]    = dot of the rejections of the endpoint direction sums
                    (the reference keeps edge_index[0] in both projection dots;
                    replicated here)

    NOTE: the reference's per-atom direction sum collapses to a scalar via a
    no-axis .sum() (data.py:239); we compute the vector sum (axis=0), i.e. the
    formula 3D-PGT intended. ``compat_reference=True`` replicates the
    reference's collapse (scalar total broadcast into all 3 coords) exactly,
    for target-level parity runs.
    """
    src, dst = edge_index[0], edge_index[1]
    d = pos[src] - pos[dst]
    bond_length = np.sum(d * d, axis=1)

    norm = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    unit = d / norm
    n_atoms = pos.shape[0]
    direction_unit = np.zeros((n_atoms, 3))
    if compat_reference:
        totals = np.zeros((n_atoms,))
        np.add.at(totals, src, unit.sum(axis=1))
        direction_unit[:] = totals[:, None]  # data.py:239 broadcast
    else:
        np.add.at(direction_unit, src, unit)
    bond_angle = np.sum(direction_unit**2, axis=1)

    unit_neg = -unit
    du_src = direction_unit[src]
    du_dst = direction_unit[dst]
    rej_pos = du_src - np.sum(du_src * unit, axis=1, keepdims=True) * unit
    rej_neg = du_dst - np.sum(du_src * unit_neg, axis=1, keepdims=True) * unit_neg
    dihedral = np.sum(rej_pos * rej_neg, axis=1)
    return bond_length, bond_angle, dihedral


def _components(mol) -> List[Tuple[int, ...]]:
    if hasattr(mol, "connected_components"):
        return mol.connected_components()
    # rdkit
    from rdkit import Chem  # pragma: no cover

    return [tuple(f) for f in Chem.GetMolFrags(mol)]  # pragma: no cover
