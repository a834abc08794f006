"""The yardstick's arithmetic against hand counts on a tiny batch."""

import math

import numpy as np
import pytest

from perfbench.common import trace
from perfbench.costs import edges, flops, kernels


class G:
    """A molecule's counts: 3 atoms in a chain (4 directed bonds), 2
    bond-graph edges, 2 fragments joined once each way, no connection
    edges."""
    n_atoms, n_edges, n_bg_edges, n_frags, n_fconn, n_fc_edges = 3, 4, 2, 2, 2, 0


def test_tcsr_forward_by_hand():
    # n 3, e 4, h 2, d 2: reads 4·(3·4 + 4·5 + 2·1 + 3·8) + 4·3·4 bytes
    nbytes, ops = kernels.tcsr_fwd(3, 4, 2, 2, tn=128)
    assert nbytes == 4 * (12 + 20 + 2 + 24) + 48
    assert ops == 4 * 2 * (2 * 2 + 6) + 3 * 4


def test_tcsr_backward_by_hand():
    nbytes, ops = kernels.tcsr_bwd(3, 4, 2, 2, True, tn=128)
    assert nbytes == 4 * (12 + 18 + 12 + 20 + 2 + 3 * 8 + 8) + 48
    assert ops == (4 + 3) * 2 * (4 * 2 + 10)


def test_dense_and_planes_by_hand():
    nbytes, ops = kernels.dense_fwd(3, 4, 2, 2, 1, tn=4)
    assert nbytes == 4 * (16 + 4 + 12 + 2 + 3 * 8) + 48
    assert ops == 4 * 2 * 6 + 2 * 4 * 4
    nbytes, ops = kernels.dense_bwd(3, 4, 2, 2, 1, tn=4)
    assert nbytes == 4 * (16 + 4 + 30 + 12 + 2 + 12 + 12 + 2) + 48
    assert ops == 4 * 2 * (8 + 2 + 6)
    nbytes, ops = kernels.planes(3, 4, 1, tn=4)
    assert nbytes == 4 * (3 * 2 * 4 + 4 * 4 + 2)
    assert ops == 8


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert kernels.bound_ms((3.35e9, 0)) == pytest.approx(1.0)
    assert kernels.bound_ms((0, 67e9)) == pytest.approx(1.0)
    assert kernels.bound_ms((3.35e9, 134e9)) == pytest.approx(2.0)


def test_gat_passes_count_the_fragment_backward_once():
    real = flops.real_counts([G()])
    tn = {"atom": 128, "bond": 128, "frag": 128, "fc": 128}
    one = kernels.gat_passes_step(real, 1, 2, 2, tn)
    two = kernels.gat_passes_step(real, 2, 2, 2, tn)
    frag_bwd = kernels.bound_ms(kernels.tcsr_bwd(2, 2, 2, 2, False))
    assert two - one == pytest.approx(one - frag_bwd)


def test_message_edges_by_hand():
    assert edges.message_edges([G(), G()], 4) == 2 * (4 + 3 + 2 + 2 + 0) * 4


def test_encoder_flops_by_hand():
    c = flops.real_counts([G()])
    emb, h = 4, 2
    d = emb // h

    def gat(e, n, da):
        return e * h * (2 * (2 * d + da) + 5 + 2 * d) + n * h * d
    want = (2 * 4 * 17 * emb + 2 * 2 * 1 * d + gat(2, 4, d)
            + 2 * 3 * 167 * emb + gat(4 + 3, 3, emb) + 3 * emb
            + 2 * 2 * 6 * emb + 0 + gat(0, 2, d) + gat(2, 2, emb))
    assert flops.encoder_forward(c, 1, emb, h) == want


def test_protein_flops_count_real_residues_only():
    one = flops.protein_forward(np.array([10]), 1, 8, 16)
    assert one == 2 * 10 * 4 * 64 + 2 * 10 * 2 * 8 * 16 + 4 * 100 * 8
    assert flops.protein_forward(np.array([10, 0]), 1, 8, 16) == one


def test_busy_is_the_union_of_device_intervals():
    iv = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 2.5)]
    assert trace.busy_seconds(iv) == pytest.approx(2.0)
    assert trace.by_name(iv + [("a", 3.0, 3.25)])[0] == ("a", 1.25)
    gaps = trace.idle_gaps(iv, [("host_op", 1.4, 1.9), ("outer", 0, 9)])
    assert gaps[0][0] == "host_op" and math.isclose(gaps[0][1], 0.5)
