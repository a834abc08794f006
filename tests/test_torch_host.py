"""The port's host pipeline (fragnet_tpu_torch: chem, graphs, TCSR metadata,
dense planes) against fragnet_tpu's, array by array, on the ``ft_graphs``
SMILES; and the port's import isolation from JAX."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from fragnet_tpu.graphs.hiergraph import pad_batch as jax_pad_batch
from fragnet_tpu.graphs.hiergraph import spec_for as jax_spec_for
from fragnet_tpu.ops.dense_gat import build_dense_planes as jax_planes
from fragnet_tpu.ops.tcsr import build_tile_meta as jax_tile_meta

from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.graphs.build import GraphBuilder as PortBuilder
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.ops.dense_gat import build_dense_planes
from fragnet_tpu_torch.ops.tcsr import build_tile_meta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GRAPH_FIELDS = ("x_atoms", "edge_index", "edge_attr", "nf_bonds", "ei_bonds",
                 "ea_bonds", "atom_to_frag", "x_frags", "frag_index",
                 "cnx_attr", "nf_fbonds", "ei_fbonds", "ea_fbonds", "y")
_TM_ARRAYS = ("ew_blk", "sw_tile", "flat_slot", "cw")
_TM_STATIC = ("tn", "te", "n_chunks", "k_src")


@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    builder = PortBuilder("exp1s")
    out = []
    for g in ft_graphs:
        mol, conf = port_engine.mol_3d(g.smiles)
        out.append(builder.build(mol, conf, g.y, smiles=g.smiles))
    return out


def test_graphs_match(ft_graphs, port_graphs):
    for gj, gp in zip(ft_graphs, port_graphs):
        for f in _GRAPH_FIELDS:
            a, b = getattr(gj, f), getattr(gp, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (gj.smiles, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{gj.smiles} {f}")


def _assert_tile_meta_equal(tj, tp, where):
    assert (tj is None) == (tp is None), where
    if tj is None:
        return
    for a in _TM_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(tj, a)),
                                      getattr(tp, a), err_msg=f"{where}.{a}")
    for a in _TM_STATIC:
        assert getattr(tj, a) == getattr(tp, a), f"{where}.{a}"


@pytest.mark.parametrize("kw", [dict(tcsr=True, align=True),
                                dict(tcsr=True, align=False),
                                dict()],
                         ids=["aligned-tcsr", "tcsr", "plain"])
def test_spec_and_pad_batch_match(ft_graphs, port_graphs, kw):
    sj = jax_spec_for(ft_graphs, batch_size=len(ft_graphs), **kw)
    sp = spec_for(port_graphs, batch_size=len(port_graphs), **kw)
    for f in dataclasses.fields(sp):
        assert getattr(sj, f.name) == getattr(sp, f.name), f.name
    bj = jax_pad_batch(ft_graphs, sj)
    bp = pad_batch(port_graphs, sp)
    for f in dataclasses.fields(bp):
        a, b = getattr(bj, f.name), getattr(bp, f.name)
        if f.name.startswith("tm_"):
            _assert_tile_meta_equal(a, b, f.name)
        elif a is None or b is None:
            assert a is None and b is None, f.name
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    if kw.get("align"):
        assert bp.dp_bond is not None and bp.dp_fc is not None


def test_tile_meta_and_planes_match_on_random_graphs():
    rng = np.random.default_rng(0)
    tn, te, n_tiles, E = 16, 16, 4, 160
    src, dst = [], []
    for t in range(n_tiles):
        for _ in range(int(rng.integers(5, 30))):
            src.append(t * tn + int(rng.integers(0, tn)))
            dst.append(t * tn + int(rng.integers(0, tn)))
    order = np.argsort(dst, kind="stable")
    s = np.zeros(E, np.int32)
    d = np.zeros(E, np.int32)
    m = np.zeros(E, np.float32)
    s[:len(order)] = np.array(src)[order]
    d[:len(order)] = np.array(dst)[order]
    m[:len(order)] = 1.0
    N = tn * n_tiles
    _assert_tile_meta_equal(jax_tile_meta(s, d, m, N, tn=tn, te=te),
                            build_tile_meta(s, d, m, N, tn=tn, te=te),
                            "random")
    # pinned widths too narrow → both refuse
    assert build_tile_meta(s, d, m, N, tn=tn, te=te, n_chunks=1) is None
    assert jax_tile_meta(s, d, m, N, tn=tn, te=te, n_chunks=1) is None
    ea = rng.standard_normal((E, 6)).astype(np.float32)
    key = d.astype(np.int64) * N + s
    first = np.zeros(E, bool)
    first[np.unique(key, return_index=True)[1]] = True
    mu = m * first  # drop duplicate (dst, src) slots so planes exist
    pj = jax_planes(s, d, mu, ea, N, tn=tn)
    pp = build_dense_planes(s, d, mu, ea, N, tn=tn)
    assert pj is not None
    np.testing.assert_array_equal(pj, pp)


def test_port_imports_no_jax():
    """Importing every fragnet_tpu_torch module (and chip_smoke) leaves no
    jax*, flax*, optax*, ml_dtypes or fragnet_tpu.* entry in sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import fragnet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            fragnet_tpu_torch.__path__, "fragnet_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "ml_dtypes")
                     or m == "fragnet_tpu" or m.startswith("fragnet_tpu."))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 20 else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_import_no_jax():
    """No import statement anywhere in the port or chip_smoke.py — lazy
    ones inside functions included — names jax, flax, optax, ml_dtypes or
    fragnet_tpu."""
    import ast

    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "fragnet_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    banned = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "fragnet_tpu")
    for p in paths:
        with open(p) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, f"{p}: imports {m}"


def test_builds_time_each_source_on_its_own(tmp_path, monkeypatch):
    """build_all starts one compiler per source at once and records each
    source's own time: a quick source is not charged the time of a slow
    one started beside it. The compiler here is a stand-in that sleeps
    and writes the library file."""
    from fragnet_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    delays = {"slow.cu": 3.0, "quick.cu": 0.0}

    class FakeCompiler(_cuda.CudaKernel):
        def compile_command(self, out):
            return [sys.executable, "-c",
                    f"import time; time.sleep({delays[self.source]}); "
                    f"open({out!r}, 'w').write('lib'); print('ptxas info')"]

    for name in delays:
        (tmp_path / name).write_text(f"// {name}\n")
    kernels = [FakeCompiler(n, "f", [], csrc=str(tmp_path)) for n in delays]
    assert not any(k in _cuda.REGISTRY for k in kernels)
    logs = _cuda.build_all(kernels)
    assert sorted(logs) == sorted(delays)
    assert all("ptxas" in log for log in logs.values())
    assert all(os.path.exists(k.so_path()) for k in kernels)
    assert _cuda.BUILD_SECONDS["slow.cu"] >= 3.0
    assert _cuda.BUILD_SECONDS["quick.cu"] < 2.5
    assert _cuda.build_all(kernels) == {}  # built: nothing to do
