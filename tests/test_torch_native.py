"""The port's C++ native host runtime (fragnet_tpu_torch/native) against
fragnet_tpu's and against the port's own Python / numpy paths, exactly: the
line graph and the TCSR windows on the random cases of tests/test_native.py
and on real batches; its build (into the package's _build/, concurrent
processes, a missing compiler, a failing one) and its call counters."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from fragnet_tpu import native as jax_native

from fragnet_tpu_torch import native
from fragnet_tpu_torch.chem import engine as port_engine
from fragnet_tpu_torch.graphs.build import (GraphBuilder,
                                            _line_graph_edges,
                                            _line_graph_edges_py)
from fragnet_tpu_torch.graphs.hiergraph import pad_batch, spec_for
from fragnet_tpu_torch.ops.tcsr import build_tile_meta, build_tile_meta_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TM = ("ew_blk", "sw_tile", "flat_slot", "cw")


def test_available_and_built_in_the_package():
    """This machine has g++: the library builds under the package's
    _build/, named by the source's and the compiler's hash."""
    assert native.available()
    assert jax_native.available()
    so = native.so_path("g++")
    assert os.path.dirname(so) == os.path.join(REPO, "fragnet_tpu_torch",
                                               "_build")
    assert os.path.exists(so)


def _random_edges(r):
    n = int(r.integers(2, 30))
    e = int(r.integers(1, 60))
    return (r.integers(0, n, e).astype(np.int32),
            r.integers(0, n, e).astype(np.int32), n)


def test_line_graph_matches_jax_and_python():
    """20 random multigraphs (self-edges and repeats included) and the
    self-edge case: the port's native line graph equals the JAX package's
    and the port's Python path, pair for pair."""
    r = np.random.default_rng(0)
    cases = [_random_edges(r) for _ in range(20)]
    cases.append((np.array([0, 0], np.int32), np.array([0, 1], np.int32), 2))
    before = native.CALLS["line_graph"]
    for src, dst, n in cases:
        got = native.line_graph(src, dst, n)
        want = jax_native.line_graph(src, dst, n)
        py = _line_graph_edges_py(list(zip(src.tolist(), dst.tolist())))
        for g, w, p in zip(got, want, py):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
    assert native.CALLS["line_graph"] == before + len(cases)


def test_native_entries_refuse_bad_indices():
    """Ids outside [0, n_nodes), unequal lengths or a wrong mask raise
    before the C code runs."""
    z = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="outside"):
        native.line_graph(z, np.array([0, 1, 2, 3], np.int32), 3)
    with pytest.raises(ValueError, match="one length"):
        native.line_graph(z, z[:3], 4)
    with pytest.raises(ValueError, match="mask"):
        native.tile_meta_arrays(z, z, np.ones(3, np.float32), 8, 8, 4,
                                None, None)


def _tile_case(r, n_mols=8):
    src_l, dst_l, off = [], [], 0
    for _ in range(n_mols):
        nn = int(r.integers(4, 20))
        ne = int(r.integers(3, 25))
        src_l.append(r.integers(0, nn, ne) + off)
        dst_l.append(r.integers(0, nn, ne) + off)
        off += nn
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    E0 = len(src)
    N = ((off + 31) // 32) * 32
    E = ((E0 + 31) // 32) * 32 + 32
    mask = np.zeros(E, np.float32)
    mask[:E0] = 1
    sp = np.zeros(E, np.int32)
    dp = np.zeros(E, np.int32)
    sp[:E0], dp[:E0] = src, dst
    return sp, dp, mask, N


def _assert_meta_equal(a, b, where):
    assert (a is None) == (b is None), where
    if a is None:
        return
    for f in _TM:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f"{where}.{f}"
        np.testing.assert_array_equal(x, y, err_msg=f"{where}.{f}")
    assert (a.tn, a.te, a.n_chunks, a.k_src) == \
        (b.tn, b.te, b.n_chunks, b.k_src), where


@pytest.mark.parametrize("pins", [(None, None), (4, 2), (1, None)],
                         ids=["auto", "pinned", "overflow"])
def test_tile_meta_matches_jax_and_numpy(pins):
    """tests/test_native.py's random layout at tn = te = 32 (and 16),
    windows auto-sized, pinned wide, and pinned too narrow ("overflow":
    both refuse): the arrays equal the JAX package's native ones and the
    port's build_tile_meta equals its numpy path."""
    r = np.random.default_rng(1)
    n_chunks, k_src = pins
    before = native.CALLS["tile_meta_arrays"]
    for t in range(4):
        sp, dp, mask, N = _tile_case(r)
        for tn in (32, 16):
            got = native.tile_meta_arrays(sp, dp, mask, N, tn, 32,
                                          n_chunks, k_src)
            want = jax_native.tile_meta_arrays(sp, dp, mask, N, tn, 32,
                                               n_chunks, k_src)
            assert (got == "overflow") == (want == "overflow")
            if pins == (1, None):
                assert got == "overflow"
            if got != "overflow":
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
            _assert_meta_equal(
                build_tile_meta(sp, dp, mask, N, tn, 32, n_chunks, k_src),
                build_tile_meta_numpy(sp, dp, mask, N, tn, 32, n_chunks,
                                      k_src), f"case {t} tn {tn}")
    assert native.CALLS["tile_meta_arrays"] == before + 16


@pytest.fixture(scope="module")
def port_graphs(ft_graphs):
    builder = GraphBuilder("exp1s")
    return [builder.build(*port_engine.mol_3d(g.smiles), g.y,
                          smiles=g.smiles) for g in ft_graphs]


def test_real_batches_native_equals_python_paths(port_graphs):
    """Each molecule's atom and fragment-connection line graphs, and each
    level's TCSR windows of a real batch (aligned and not), native vs the
    Python / numpy paths: equal. The graphs themselves equal the JAX
    package's (tests/test_torch_host.py::test_graphs_match)."""
    for g in port_graphs:
        for ei in (g.edge_index, g.frag_index):
            ends = list(zip(ei[0].tolist(), ei[1].tolist()))
            assert _line_graph_edges(ends) == _line_graph_edges_py(ends)
    levels = {"atom": ("edge_src", "edge_dst", "edge_mask", "n_atoms"),
              "bond": ("bg_src", "bg_dst", "bg_mask", "n_edges"),
              "frag": ("frag_src", "frag_dst", "fconn_mask", "n_frags"),
              "fc": ("fc_src", "fc_dst", "fc_mask", "n_fconn")}
    for align in (True, False):
        spec = spec_for(port_graphs, batch_size=len(port_graphs), tcsr=True,
                        align=align)
        b = pad_batch(port_graphs, spec)
        for lvl, (s, d, m, n) in levels.items():
            tm = getattr(b, f"tm_{lvl}")
            assert tm is not None
            args = (getattr(b, s), getattr(b, d), getattr(b, m),
                    getattr(spec, n))
            kw = dict(tn=spec.tn_of(lvl), te=spec.te,
                      n_chunks=tm.n_chunks, k_src=tm.k_src)
            _assert_meta_equal(tm, build_tile_meta_numpy(*args, **kw),
                               f"{lvl} align={align}")


def test_concurrent_builds_into_a_fresh_directory(tmp_path):
    """Three processes building at once into an empty directory each load
    a whole library (each writes its own file and moves it into place)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from fragnet_tpu_torch import native
        native.BUILD_DIR = {str(tmp_path)!r}
        assert native.available()
        out = native.line_graph([0, 1, 1], [1, 2, 0], 3)
        print(out[0].tolist(), out[1].tolist())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    want = " ".join(str(x) for x in _line_graph_edges_py([(0, 1), (1, 2),
                                                          (1, 0)]))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == want
    assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] == \
        [os.path.basename(native.so_path("g++"))]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_no_compiler_takes_the_python_paths(monkeypatch, port_graphs):
    """With no g++ on PATH the runtime is unavailable and the callers give
    the same results through their Python / numpy paths; a g++ that fails
    raises instead of falling back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert native.line_graph(np.zeros(1, np.int32), np.ones(1, np.int32),
                             2) is None
    g = port_graphs[1]
    ends = list(zip(g.edge_index[0].tolist(), g.edge_index[1].tolist()))
    assert _line_graph_edges(ends) == _line_graph_edges_py(ends)

    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: "/bin/false")
    monkeypatch.setattr(native, "so_path",
                        lambda cxx: os.path.join(native.BUILD_DIR,
                                                 "never-built.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()
