"""CDRP dataset creation: SMILES + gene-expression vector + drug response
(counterpart of fragnet_tpu/data/cdrp.py).

Reference: fragnet/dataset/cdrp.py (GDSC via the vendored DeepTTC pipeline,
dataset/ext_data_utils/) and data.py:717-874 (CreateDataCDRP). A response
table is a column dict (``smiles``, ``cell_line``, ``y``); the expression
table is (cell-line ids, an (n_cells, gene_dim) f32 matrix), row i being
cell line i's.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

GENE_DIM = 903  # GDSC RMA subset size used by the reference (cdrp/model.py:7)


def build_cdrp_graphs(df: Dict[str, object],
                      gene_expr: Tuple[Sequence[str], np.ndarray],
                      data_type: str = "exp1s", frag_type: str = "brics",
                      seed: int = 42):
    """df columns: smiles, cell_line, y; ``gene_expr`` = (cell-line ids,
    their expression rows). Pairs whose cell line has no row are
    skipped."""
    from fragnet_tpu_torch.chem import engine
    from fragnet_tpu_torch.graphs.build import GraphBuilder

    cells, expr = gene_expr
    row_of = {c: i for i, c in enumerate(cells)}
    builder = GraphBuilder(data_type)
    out = []
    for smiles, cell, y in zip(df["smiles"], df["cell_line"], df["y"]):
        if cell not in row_of:
            continue
        r = engine.mol_3d(smiles, seed=seed)
        if r is None:
            continue
        mol, conf = r
        g = builder.build(
            mol, conf, [y], smiles=smiles, frag_type=frag_type,
            gene_expr=np.asarray(expr[row_of[cell]], np.float32),
        )
        if g is not None:
            out.append(g)
    return out


def synthetic_cdrp_dataset(n: int = 128, n_cells: int = 10,
                           gene_dim: int = GENE_DIM, seed: int = 0):
    """Synthetic (drug, cell) pairs: response = drug logP × cell sensitivity
    factor (a fixed linear readout of its expression vector). The same
    draws as the JAX package's; returns (response column dict, (cell ids,
    expression matrix))."""
    from fragnet_tpu_torch.chem.smiles import MolFromSmiles
    from fragnet_tpu_torch.data.synthetic import pseudo_logp, random_smiles

    rng = np.random.default_rng(seed)
    cells = [f"CELL_{i:03d}" for i in range(n_cells)]
    expr = rng.standard_normal((n_cells, gene_dim)).astype(np.float32)
    readout = rng.standard_normal(gene_dim) / np.sqrt(gene_dim)
    sensitivity = expr @ readout

    smiles, cell_lines, ys = [], [], []
    while len(smiles) < n:
        s = random_smiles(rng)
        if MolFromSmiles(s) is None:
            continue
        ci = int(rng.integers(0, n_cells))
        y = 2.0 + pseudo_logp(s) * 0.5 + float(sensitivity[ci])
        smiles.append(s)
        cell_lines.append(cells[ci])
        ys.append(y)
    df = {"smiles": smiles, "cell_line": cell_lines,
          "y": np.array(ys, np.float64)}
    return df, (cells, expr)
