"""Interactive interpretability app — the analog of fragnet/vizualize/app.py
(Streamlit, README.md:160); counterpart of fragnet_tpu/interp/app.py.

* With streamlit installed:  ``streamlit run fragnet_tpu_torch/interp/app.py``
* Without (zero-dep fallback): ``python -m fragnet_tpu_torch.interp.app
  --smiles CCO --config <cfg> --ckpt <ft.ckpt> --out report.html
  [--device cpu]`` writes a standalone HTML report with the same four tabs'
  content (atoms / bonds / fragments / fragment-connections, attention +
  masking contributions). The model runs on the card unless ``--device
  cpu`` asks for the CPU; the checkpoint is a port ``ft.ckpt``
  (train/checkpoint.py:save_params).
"""

from __future__ import annotations

import argparse
import os
import sys


def _load_model(config_path: str, ckpt_path: str, device="cuda"):
    """The config's model under its kernel policy, its weights from
    ``ckpt_path`` when that exists (else seeded at random), wrapped in a
    FragNetInterpreter on ``device``."""
    import torch

    from fragnet_tpu_torch.config import load_config
    from fragnet_tpu_torch.interp.attention import FragNetInterpreter
    from fragnet_tpu_torch.train.checkpoint import load_params
    from fragnet_tpu_torch.train.fastpath import resolve_kernel_policy
    from fragnet_tpu_torch.train.finetune import build_model

    opt = load_config(config_path)
    model = build_model(opt, n_classes=int(opt.finetune.get("n_classes", 1)),
                        policy=resolve_kernel_policy(opt.finetune),
                        generator=torch.Generator().manual_seed(0))
    if ckpt_path and os.path.exists(ckpt_path):
        load_params(model, ckpt_path)
    return FragNetInterpreter(model, device=device)


def run_cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smiles", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="interpretation.html")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args()

    from fragnet_tpu_torch.chem.smiles import MolFromSmiles
    from fragnet_tpu_torch.interp.render import render_report

    # validate input before paying for model build/compile
    if MolFromSmiles(args.smiles) is None:
        print(f"error: could not parse SMILES {args.smiles!r}")
        raise SystemExit(2)

    interp = _load_model(args.config, args.ckpt, device=args.device)
    result = interp.interpret(args.smiles, with_contributions=True)
    path = render_report(result, args.out)
    print(f"prediction: {result.prediction:.4f}")
    print(f"report: {path}")


# property registry for the sidebar selector (reference vizualize/config.py:
# PROP_LIST / resolve_prop_model, app.py:38-64); entries are
# name → (config_path, checkpoint_path, description for the model card)
PROPERTIES = {
    "Solubility (ESOL)": ("configs/ft/esol.yaml", "exps/ft/esol/ft.ckpt",
                          "log solubility in mols/L, MoleBert scaffold split"),
    "Lipophilicity": ("configs/ft/lipo.yaml", "exps/ft/lipo/ft.ckpt",
                      "octanol/water logD at pH 7.4"),
    "Custom (paths below)": (None, None, "user-supplied config/checkpoint"),
}


def run_streamlit() -> None:  # pragma: no cover - needs streamlit
    import streamlit as st

    st.set_page_config(page_title="FragNet-TPU interpretability")
    st.title("FragNet-TPU — molecular interpretability")
    # per-property selector + model card (reference app.py:99-108 sidebar)
    prop = st.sidebar.selectbox("property", list(PROPERTIES))
    p_cfg, p_ckpt, p_desc = PROPERTIES[prop]
    config = st.sidebar.text_input("config YAML",
                                   p_cfg or "configs/ft/esol.yaml")
    ckpt = st.sidebar.text_input("checkpoint", p_ckpt or "")
    with st.sidebar.expander("model card"):
        st.write(f"**{prop}** — {p_desc}")
        st.write(f"config: `{config}`")
        st.write(f"checkpoint: `{ckpt or '(random init)'}`")
    # molecule input: Ketcher editor when the component is installed
    # (reference app.py:99-108), plain text box otherwise
    smiles = None
    try:
        from streamlit_ketcher import st_ketcher

        smiles = st_ketcher("CC(=O)Oc1ccccc1C(=O)O")
    except ImportError:
        smiles = st.text_input("SMILES", "CC(=O)Oc1ccccc1C(=O)O")
    if st.button("Interpret") and smiles:
        from fragnet_tpu_torch.interp.render import draw_molecule

        interp = _load_model(config, ckpt or None)
        res = interp.interpret(smiles)
        st.metric("prediction", f"{res.prediction:.4f}")
        tabs = st.tabs(["Atoms", "Bonds", "Fragments", "Connections"])
        import numpy as np

        with tabs[0]:
            st.image(draw_molecule(res.mol, atom_colors=res.atom_weights))
            if res.atom_contrib is not None:
                st.image(draw_molecule(res.mol, atom_colors=res.atom_contrib,
                                       signed=True))
        with tabs[1]:
            # attention image + masking-contribution image + table — the
            # reference pairs images with tables in every tab (app.py:187-297)
            bw = np.zeros(res.mol.GetNumBonds())
            bw[: len(res.bond_weights)] = res.bond_weights[: len(bw)]
            st.image(draw_molecule(res.mol, bond_colors=bw))
            if res.bond_contrib is not None:
                bc = np.zeros(res.mol.GetNumBonds())
                bc[: len(res.bond_contrib)] = res.bond_contrib[: len(bc)]
                st.image(draw_molecule(res.mol, bond_colors=bc, signed=True))
                st.dataframe({
                    "bond": list(range(len(res.bond_weights))),
                    "attention": res.bond_weights,
                    "contribution": res.bond_contrib[: len(res.bond_weights)],
                })
        with tabs[2]:
            fa = res.frag_weights[np.asarray(res.graph.atom_to_frag)]
            st.image(draw_molecule(res.mol, atom_colors=fa,
                                   frag_of_atom=res.graph.atom_to_frag))
            st.dataframe({
                "fragment": list(range(len(res.frag_weights))),
                "attention": res.frag_weights,
                "contribution": res.frag_contrib,
            })
        with tabs[3]:
            # connection weights highlighted on the REAL bonds they cut
            # (viz.py:857-898 frag_weight_highlight) + the table
            if res.fconn_bonds:
                cw = np.zeros(res.mol.GetNumBonds())
                for k, (i, j) in enumerate(res.fconn_bonds):
                    if k >= len(res.fconn_weights):
                        break
                    b = res.mol.GetBondBetweenAtoms(int(i), int(j))
                    if b is not None:
                        cw[b.GetIdx()] = res.fconn_weights[k]
                st.image(draw_molecule(res.mol, bond_colors=cw))
            st.dataframe({
                "connection": list(range(len(res.fconn_weights))),
                "attention": res.fconn_weights,
                "contribution": res.fconn_contrib,
            })


if __name__ == "__main__":
    try:
        import streamlit  # noqa: F401

        in_streamlit = os.environ.get("STREAMLIT_SERVER_PORT") is not None
    except ImportError:
        in_streamlit = False
    if in_streamlit:  # pragma: no cover
        run_streamlit()
    else:
        run_cli()
elif "streamlit" in sys.modules:  # pragma: no cover - streamlit run imports
    run_streamlit()
