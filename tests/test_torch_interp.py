"""The port's interpretability (fragnet_tpu_torch/interp/, LayerHooks in
model/layers.py) against fragnet_tpu's, on the CPU. Small models: 2 layers,
emb 32, 2 heads (tests/test_interp.py's widths), weights carried across
with ``state_dict_from_jax``.

* Hooked forwards — each LayerHooks field, and all of them at once — on the
  segment route, the TCSR-plus-planes route and the dense-attr route
  (plain versions) against ``FragNetFineTune.apply(..., hooks=...)`` on
  the same tile-aligned batch: prediction and the last layer's four
  attention vectors within 1e-4 relative. −1 is a no-op in every field.
* The interpreter on aspirin, benzene (one fragment: the unpaired self_cn
  layout) and [Na+].[Cl-].CCO (iso_cn3 connections) against the JAX
  interpreter: the prediction and the four contribution vectors within
  1e-4 of their scale, the four min-max-scaled weight vectors within atol
  1e-4. A contribution is the difference of two near-equal predictions,
  so its scale is that of the predictions: max(|prediction|, max|c|).
* Each family's replica-batch contributions against one-at-a-time masked
  forwards of the one-molecule batch (1e-4 of scale), on a batch where
  tile alignment moves replicas off multiples of the molecule's size;
  every replica's masked rows are its own.
* Ports of tests/test_interp.py: shapes, invalid SMILES, the
  connection → bond map, the fold alignment, the unpaired layout, the
  renderings and HTML report, the CLI, and the Streamlit app under a stub.
"""

import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.interp.attention import FragNetInterpreter as JaxInterpreter
from fragnet_tpu.model.finetune import FragNetFineTune as JaxModel
from fragnet_tpu.model.layers import LayerHooks as JaxHooks

from fragnet_tpu_torch.chem import engine
from fragnet_tpu_torch.chem.fragments import FragmentedMol
from fragnet_tpu_torch.graphs.batch import to_device
from fragnet_tpu_torch.graphs.build import GraphBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.interp import attribution
from fragnet_tpu_torch.interp.attention import (FragNetInterpreter,
                                                fconn_real_bonds)
from fragnet_tpu_torch.model.finetune import FragNetFineTune
from fragnet_tpu_torch.model.layers import (KernelPolicy, LayerHooks,
                                            _zero_rows)
from fragnet_tpu_torch.train.checkpoint import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layer=2, num_heads=2, emb_dim=32, h1=16, h2=16, h3=16,
             h4=16, drop_ratio=0.0)
MOLECULES = ["CC(=O)Oc1ccccc1C(=O)O", "c1ccccc1", "[Na+].[Cl-].CCO"]
WEIGHTS = ("atom_weights", "bond_weights", "frag_weights", "fconn_weights")
CONTRIBS = ("atom_contrib", "bond_contrib", "frag_contrib", "fconn_contrib")
_NO_KERNELS = dict(tm_atom=None, tm_bond=None, tm_frag=None, tm_fc=None,
                   dp_bond=None, dp_fc=None, dp_atom=None, dp_frag=None)


def _close(port, ref, rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * float(np.abs(ref).max()))


def _contrib_close(port, ref, prediction, rel=1e-4):
    """Within ``rel`` of the scale of the predictions they are differences
    of (the tests' and chip_smoke.py's contribution tolerance)."""
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(abs(prediction), float(np.abs(ref).max(initial=0.0)))
    assert float(np.abs(port - ref).max(initial=0.0)) <= rel * scale


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's forwards are small: one intra-op thread each, so that
    test workers sharing the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_interp():
    model = JaxModel(**SMALL)
    it = JaxInterpreter(model, None)
    _g, _mol, batch = it.featurize("CCO")
    # jitted: the same params as tests/test_interp.py's eager init, faster
    init = jax.jit(lambda k, b: model.init(k, b, deterministic=True))
    it.params = init(jax.random.PRNGKey(0), batch)
    return it


@pytest.fixture(scope="module")
def port_model(jax_interp):
    model = FragNetFineTune(**SMALL)
    model.load_state_dict(state_dict_from_jax(jax_interp.params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def interp(port_model):
    return FragNetInterpreter(port_model, device="cpu")


# ---- hooked forwards --------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    """The port's MolGraph of each of MOLECULES and of ethanol."""
    builder = GraphBuilder("exp1s")
    return {s: builder.build(*engine.mol_3d(s), [0.0], smiles=s)
            for s in ["CCO"] + MOLECULES}


@pytest.fixture(scope="module")
def aligned(graphs):
    """(JAX batch, port batch) of ethanol, aspirin and benzene (the same
    graphs padded by each package), tile-aligned with TCSR metadata and
    every plane level."""
    gs = [graphs[s] for s in ("CCO", MOLECULES[0], MOLECULES[1])]
    kw = dict(batch_size=3, tcsr=True, align=True)
    bj = jax_pad_batch(gs, jax_spec_for(gs, **kw))
    bp = pad_batch(gs, spec_for(gs, **kw))
    assert bp.tm_atom is not None and bp.dp_bond is not None
    bj = jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                      dataclasses.replace(bj, **_NO_KERNELS))
    return bj, bp


def _hook_case(name, bp):
    """{field: value} of one hook case on the aligned batch."""
    frag2 = ((bp.atom_to_frag == 2) * bp.atom_mask).astype(np.float32)
    cases = {"bond_mask": {"bond_mask": 6}, "frag_bond_mask":
             {"frag_bond_mask": 1}, "atom_mask": {"atom_mask": 3},
             "atom_zero_vec": {"atom_zero_vec": frag2}}
    if name == "all":
        return {k: v for c in cases.values() for k, v in c.items()}
    return cases[name]


@pytest.fixture(scope="module")
def jax_hooked(jax_interp, aligned):
    """The JAX model's (prediction, attentions) under each hook case."""
    model, params = jax_interp.model, jax_interp.params
    bj, bp = aligned
    out = {}
    for name in ("bond_mask", "frag_bond_mask", "atom_mask", "atom_zero_vec",
                 "all"):
        h = JaxHooks(**{k: jnp.asarray(v)
                        for k, v in _hook_case(name, bp).items()})
        out[name] = model.apply(params, bj, deterministic=True,
                                hooks=[h] * model.num_layer,
                                return_attentions=True)
    return out


@pytest.fixture(scope="module")
def attr_model(port_model):
    """The carried model under the dense-attr policy (K7's plain version
    at the atom, fconn and frag passes)."""
    model = FragNetFineTune(**SMALL, policy=KernelPolicy(attr=True, fc="attr"))
    model.load_state_dict(port_model.state_dict(), strict=True)
    return model.eval()


@pytest.mark.parametrize("route", ["segment", "tcsr-planes", "dense-attr"])
@pytest.mark.parametrize("case", ["bond_mask", "frag_bond_mask", "atom_mask",
                                  "atom_zero_vec", "all"])
def test_hooked_forward_matches_jax(port_model, attr_model, aligned,
                                    jax_hooked, route, case):
    _bj, bp = aligned
    model = attr_model if route == "dense-attr" else port_model
    if route == "segment":
        bp = dataclasses.replace(bp, **_NO_KERNELS)
    h = LayerHooks(**{k: torch.as_tensor(v)
                      for k, v in _hook_case(case, bp).items()})
    with torch.no_grad():
        pred, attn = model(to_device(bp, "cpu"), return_attentions=True,
                           hooks=[h] * 2)
        plain = model(to_device(bp, "cpu"))
    pred_j, attn_j = jax_hooked[case]
    _close(pred, pred_j)
    assert not torch.allclose(pred, plain)  # the hook changed something
    for level in ("atoms", "frags", "bonds", "fbonds"):
        _close(getattr(attn, level), getattr(attn_j, level))


@pytest.mark.parametrize("route", ["segment", "tcsr-planes"])
def test_minus_one_is_a_no_op(port_model, aligned, route):
    """−1 in every index field changes no bit (torch would wrap −1 to the
    last row); the JAX package agrees for atom_mask and frag_bond_mask,
    while its bond_mask = −1 zeroes bond row 0 (its pair [−1, 0]) — the
    port keeps −1 disabled there too."""
    _bj, bp = aligned
    if route == "segment":
        bp = dataclasses.replace(bp, **_NO_KERNELS)
    b = to_device(bp, "cpu")
    h = LayerHooks(bond_mask=-1, frag_bond_mask=-1, atom_mask=-1,
                   bond_rows=torch.tensor([-1]),
                   fconn_rows=torch.tensor([-1]),
                   atom_rows=torch.tensor([-1]))
    with torch.no_grad():
        assert torch.equal(port_model(b, hooks=[h] * 2), port_model(b))
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(_zero_rows(x, -1, torch.tensor([-1, 4])), x)
    assert torch.equal(_zero_rows(x, torch.tensor([1, -1]))[1], x[1] * 0)


def test_jax_bond_mask_minus_one_zeroes_row_0(jax_interp, aligned,
                                              port_model):
    """Pins the difference the port documents: the JAX bond_mask = −1 is
    the port's bond_rows = [0]."""
    bj, bp = aligned
    model, params = jax_interp.model, jax_interp.params
    ref = model.apply(params, bj, deterministic=True,
                      hooks=[JaxHooks(bond_mask=jnp.asarray(-1))] * 2)
    b = to_device(dataclasses.replace(bp, **_NO_KERNELS), "cpu")
    with torch.no_grad():
        got = port_model(b, hooks=[LayerHooks(
            bond_rows=torch.tensor([0]))] * 2)
    _close(got, ref)


# ---- the interpreter against the JAX package's ------------------------------

@pytest.fixture(scope="module")
def results(jax_interp, interp):
    return {s: (jax_interp.interpret(s, with_contributions=True),
                interp.interpret(s, with_contributions=True))
            for s in MOLECULES}


@pytest.mark.parametrize("smiles", MOLECULES)
def test_interpreter_matches_jax(results, smiles):
    rj, rp = results[smiles]
    scale = max(abs(rj.prediction), 1e-30)
    assert abs(rp.prediction - rj.prediction) <= 1e-4 * scale
    for f in WEIGHTS:
        got, want = getattr(rp, f), np.asarray(getattr(rj, f))
        assert got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=f)
    for f in CONTRIBS:
        _contrib_close(getattr(rp, f), getattr(rj, f), rj.prediction)
    assert rp.fconn_bonds == rj.fconn_bonds
    assert rp.graph.n_atoms == rj.graph.n_atoms
    assert rp.graph.n_fconn == rj.graph.n_fconn


# ---- replica batches against one-at-a-time masked forwards ------------------

def _one_at_a_time(model, b, family, i):
    """The prediction with entity i masked, on the one-molecule batch ``b``,
    through the reference's hook conventions."""
    if family == "atom":
        h = LayerHooks(atom_mask=i)
    elif family == "bond":
        h = LayerHooks(bond_mask=2 * i)
    elif family == "fconn":
        h = LayerHooks(frag_bond_mask=i)
    else:
        vec = (b.atom_to_frag == i) * b.atom_mask
        h = LayerHooks(atom_zero_vec=torch.as_tensor(vec, dtype=torch.float32))
    return float(attribution.predict(model, b, h)[0, 0])


_FAMILY_FN = {"atom": attribution.atom_contributions,
              "bond": attribution.bond_contributions,
              "fconn": attribution.fconn_contributions,
              "fragment": attribution.fragment_contributions}


@pytest.mark.parametrize("smiles", MOLECULES)
@pytest.mark.parametrize("family", attribution.FAMILIES)
def test_replica_contributions_match_one_at_a_time(port_model, graphs,
                                                   smiles, family):
    g = graphs[smiles]
    got = _FAMILY_FN[family](port_model, g)
    assert got.shape[0] >= 1
    b = to_device(attribution.pad_graphs([g]), "cpu")
    base = float(attribution.predict(port_model, b)[0, 0])
    want = [base - _one_at_a_time(port_model, b, family, i)
            for i in range(got.shape[0])]
    _contrib_close(got, np.array(want), base)


@pytest.mark.parametrize("smiles", MOLECULES)
@pytest.mark.parametrize("family", attribution.FAMILIES)
def test_replica_masks_touch_only_their_own_rows(graphs, smiles, family):
    """Every masked row lies in its own replica (the row after a single
    fragment's one fconn row is the next replica's); on aspirin, tile
    alignment moves replicas off multiples of the molecule's size."""
    g = graphs[smiles]
    n = {"atom": g.n_atoms, "bond": g.n_edges // 2,
         "fconn": attribution.n_connections(g), "fragment": g.n_frags}[family]
    b, fields = attribution.replica_batch(g, family, n)
    (field, rows), = fields.items()
    atom_owner = np.where(b.atom_mask > 0, b.atom_batch, -1)
    if family == "fragment":
        rows = np.flatnonzero(rows)
        a_off = attribution._first_rows(b.atom_batch, b.atom_mask, n + 1)
        owner = atom_owner[rows]
        local = np.asarray(g.atom_to_frag)[rows - a_off[owner]]
        np.testing.assert_array_equal(owner, 1 + local)
        assert set(owner.tolist()) == set(range(1, n + 1))
        return
    owner = {"atom_rows": atom_owner,
             "bond_rows": np.where(b.edge_mask > 0,
                                   b.atom_batch[b.edge_src], -1),
             "fconn_rows": np.where(b.fconn_mask > 0,
                                    b.frag_batch[b.frag_src], -1)}[field]
    per_entity = {"atom": 1, "bond": 2, "fconn": min(2, g.n_fconn)}[family]
    want = 1 + np.repeat(np.arange(n), per_entity)
    np.testing.assert_array_equal(owner[rows], want)
    if smiles == MOLECULES[0] and family == "atom":
        starts = attribution._first_rows(b.atom_batch, b.atom_mask, n + 1)
        assert (starts != np.arange(n + 1) * g.n_atoms).any()


# ---- ports of tests/test_interp.py ------------------------------------------

def test_weights_shapes(results):
    res = results["CC(=O)Oc1ccccc1C(=O)O"][1]
    g = res.graph
    assert res.atom_weights.shape == (g.n_atoms,)
    assert res.bond_weights.shape == (g.n_edges // 2,)
    assert res.frag_weights.shape == (g.n_frags,)
    assert np.isfinite(res.prediction)
    for w in (res.atom_weights, res.bond_weights, res.frag_weights):
        assert w.min() >= 0.0 and w.max() <= 1.0 + 1e-6
    assert res.atom_contrib.shape == (g.n_atoms,)
    assert res.frag_contrib.shape == (g.n_frags,)
    assert np.isfinite(res.atom_contrib).all()
    assert np.abs(res.atom_contrib).max() > 0


def test_invalid_smiles_raises(interp):
    with pytest.raises(ValueError):
        interp.interpret("not_a_smiles((")


def test_fconn_real_bonds_cut_bonds():
    mol, conf = engine.mol_3d("CC(=O)Oc1ccccc1C(=O)O")
    fm = FragmentedMol(mol, conf)
    pairs = fconn_real_bonds(fm)
    assert len(pairs) == len(fm.connections)
    real_bonds = {frozenset((b.begin, b.end)) for b in mol.bonds}
    for cn, (i, j) in zip(fm.connections, pairs):
        if cn.bond_id is not None:
            assert frozenset((i, j)) in real_bonds


def test_iso_cn3_fallback_spans_components():
    mol, conf = engine.mol_3d("[Na+].[Cl-].CCO")
    fm = FragmentedMol(mol, conf)
    pairs = fconn_real_bonds(fm)
    iso = [p for cn, p in zip(fm.connections, pairs)
           if cn.bond_type == "iso_cn3"]
    assert iso, "expected iso_cn3 connections for a disconnected mol"
    for i, j in iso:
        assert i != j


def test_folded_index_aligns_with_connections(results):
    """Folded weight k ↔ builder connection k ↔ fconn_real_bonds[k]: the
    directed fconn rows (2k, 2k+1) connect exactly connection k's pair."""
    s = "CC(=O)Oc1ccccc1C(=O)O"
    res = results[s][1]
    g = res.graph
    assert g.n_frags > 1 and g.n_fconn % 2 == 0
    n_fold = g.n_fconn // 2
    assert len(res.fconn_weights) == n_fold == len(res.fconn_bonds)
    assert len(res.fconn_contrib) == n_fold
    mol, _ = engine.mol_3d(s)
    fm = FragmentedMol(mol, None)
    assert len(fm.connections) == n_fold
    fi = np.asarray(g.frag_index)
    for k, cn in enumerate(fm.connections):
        want = {cn.BeginFragIdx, cn.EndFragIdx}
        assert {int(fi[0, 2 * k]), int(fi[1, 2 * k])} == want, k
        assert {int(fi[0, 2 * k + 1]), int(fi[1, 2 * k + 1])} == want, k
        i, j = res.fconn_bonds[k]
        atoms = set(cn.frags[0].atom_indices) | set(cn.frags[1].atom_indices)
        assert i in atoms and j in atoms, k


def test_self_cn_unpaired_layout(results):
    res = results["c1ccccc1"][1]
    assert res.graph.n_frags == 1
    assert res.graph.n_fconn == 1
    assert len(res.fconn_weights) == 1 == len(res.fconn_bonds)
    assert res.fconn_contrib.shape == (1,)


def test_unpaired_never_mixes_with_paired():
    builder = GraphBuilder("exp1s")
    for s in ["c1ccccc1", "CC", "CC(=O)Oc1ccccc1C(=O)O", "CC.OCO",
              "[Na+].[Cl-].CCO", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]:
        mol, conf = engine.mol_3d(s)
        g = builder.build(mol, conf, [0.0], smiles=s)
        fi = np.asarray(g.frag_index)
        if g.n_frags == 1:
            assert g.n_fconn == 1, s
        else:
            assert g.n_fconn % 2 == 0 and g.n_fconn >= 2, s
            for k in range(g.n_fconn // 2):
                assert (fi[0, 2 * k], fi[1, 2 * k]) == \
                    (fi[1, 2 * k + 1], fi[0, 2 * k + 1]), (s, k)


def test_draw_and_report(results, tmp_path):
    from fragnet_tpu_torch.interp.render import draw_molecule, render_report

    res = results["CC(=O)Oc1ccccc1C(=O)O"][1]
    png = draw_molecule(res.mol, atom_colors=res.atom_weights)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    out = render_report(res, str(tmp_path / "r.html"))
    html = open(out).read()
    assert "prediction" in html and "data:image/png;base64" in html
    assert "connection" in html


def test_cli_writes_the_report_from_a_checkpoint(port_model, interp,
                                                 tmp_path, monkeypatch,
                                                 capsys):
    """``python -m fragnet_tpu_torch.interp.app --device cpu``: the config's
    model with the checkpoint's weights gives the interpreter's prediction."""
    from fragnet_tpu_torch.interp import app
    from fragnet_tpu_torch.train.checkpoint import save_params

    cfg = tmp_path / "small.yaml"
    cfg.write_text(
        "finetune:\n  model:\n    num_layer: 2\n    num_heads: 2\n"
        "    emb_dim: 32\n    h1: 16\n    h2: 16\n    h3: 16\n    h4: 16\n"
        "    drop_ratio: 0.0\n    act: celu\n")
    ckpt = str(tmp_path / "ft.ckpt")
    save_params(port_model, ckpt)
    out = str(tmp_path / "report.html")
    monkeypatch.setattr(sys, "argv", [
        "app", "--smiles", "CCO", "--config", str(cfg), "--ckpt", ckpt,
        "--out", out, "--device", "cpu"])
    app.run_cli()
    text = capsys.readouterr().out
    want = interp.interpret("CCO", with_contributions=False).prediction
    assert f"prediction: {want:.4f}" in text
    assert "data:image/png;base64" in open(out).read()


def test_run_streamlit_under_stub(monkeypatch):
    """interp/app.py's streamlit branch under a recording stub (streamlit
    is not installed here): the app flow, not the web server. The model is
    the esol config's at full width, on the CPU."""
    from fragnet_tpu_torch.interp import app

    calls = {"image": 0, "dataframe": 0, "metric": [], "tabs": 0}

    class _Ctx:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _Sidebar:
        @staticmethod
        def selectbox(label, options):
            return list(options)[0]  # "Solubility (ESOL)"

        @staticmethod
        def text_input(label, value=""):
            return value if "config" in label.lower() else ""

        @staticmethod
        def expander(label):
            return _Ctx()

    st = types.ModuleType("streamlit")
    st.set_page_config = lambda **kw: None
    st.title = lambda *a: None
    st.sidebar = _Sidebar()
    st.write = lambda *a, **kw: None
    st.text_input = lambda label, value="": value
    st.button = lambda label: True
    st.metric = lambda label, v: calls["metric"].append(v)

    def _tabs(names):
        calls["tabs"] = len(names)
        return [_Ctx() for _ in names]

    st.tabs = _tabs
    st.image = lambda *a, **kw: calls.__setitem__("image",
                                                  calls["image"] + 1)
    st.dataframe = lambda *a, **kw: calls.__setitem__(
        "dataframe", calls["dataframe"] + 1)

    load = app._load_model
    monkeypatch.setattr(app, "_load_model",
                        lambda c, k: load(c, k, device="cpu"))
    monkeypatch.chdir(REPO)
    monkeypatch.setitem(sys.modules, "streamlit", st)
    app.run_streamlit()

    assert calls["metric"], "no prediction rendered"
    assert calls["tabs"] == 4
    assert calls["image"] >= 3
    assert calls["dataframe"] >= 2
