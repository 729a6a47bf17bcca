"""The port's automorphism-matched D-MAE against the JAX package's
(``tsdiff_tpu/eval/dmae.py``, pure numpy): the automorphism lists must be
equal, element by element and in order, and the D-MAE values equal to 1e-12,
on graphs with symmetric atoms, on a graph whose only automorphism is the
identity, and on a seeded synthetic corpus."""

import numpy as np
import pytest

from tsdiff_tpu.eval import dmae as jdmae
from tsdiff_tpu_torch.data.synthetic import make_corpus
from tsdiff_tpu_torch.eval import dmae as tdmae

SINGLE = 1 * 5 + 1  # a bond present as single in both reactant and product


def methane_like():
    """C bonded to four H: 24 automorphisms (the H in any order)."""
    bond = np.zeros((5, 5), np.int64)
    bond[0, 1:] = bond[1:, 0] = SINGLE
    return bond, np.array([6, 1, 1, 1, 1])


def ethane_methyls():
    """C-C with three H on each: 2 * 3! * 3! = 72 automorphisms."""
    bond = np.zeros((8, 8), np.int64)
    bond[0, 1] = bond[1, 0] = SINGLE
    for c, hs in ((0, (2, 3, 4)), (1, (5, 6, 7))):
        for h in hs:
            bond[c, h] = bond[h, c] = SINGLE
    return bond, np.array([6, 6, 1, 1, 1, 1, 1, 1])


def benzene_ring():
    """Six C in a ring: the dihedral group, 12 automorphisms."""
    bond = np.zeros((6, 6), np.int64)
    for i in range(6):
        j = (i + 1) % 6
        bond[i, j] = bond[j, i] = SINGLE
    return bond, np.full(6, 6)


def asymmetric_chain():
    """A chain of distinct atom types: the identity alone."""
    bond = np.zeros((5, 5), np.int64)
    for i in range(4):
        bond[i, i + 1] = bond[i + 1, i] = SINGLE
    return bond, np.array([6, 7, 8, 9, 16])


GRAPHS = {"methane": (methane_like, 24), "ethane": (ethane_methyls, 72),
          "benzene": (benzene_ring, 12), "asymmetric": (asymmetric_chain, 1)}


def assert_same_autos(bond, types):
    mine = tdmae.graph_automorphisms(bond, types)
    ref = jdmae.graph_automorphisms(bond, types)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    return mine


@pytest.mark.parametrize("name", list(GRAPHS))
def test_automorphisms_equal_the_reference(name):
    make, count = GRAPHS[name]
    bond, types = make()
    autos = assert_same_autos(bond, types)
    assert len(autos) == count
    n = len(types)
    np.testing.assert_array_equal(autos[0], np.arange(n))    # the identity comes first
    for p in autos:
        np.testing.assert_array_equal(types[p], types)
        np.testing.assert_array_equal(bond[np.ix_(p, p)], bond)


def test_max_perms_caps_the_search_as_the_reference_does():
    bond, types = ethane_methyls()
    for cap in (1, 5, 72, 100):
        mine = tdmae.graph_automorphisms(bond, types, max_perms=cap)
        ref = jdmae.graph_automorphisms(bond, types, max_perms=cap)
        assert len(mine) == len(ref) == min(cap, 72)
        assert all(np.array_equal(a, b) for a, b in zip(mine, ref))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_min_match_and_graph_dmae_equal_the_reference(name):
    bond, types = GRAPHS[name][0]()
    n = len(types)
    rng = np.random.default_rng(n)
    pos_ref = rng.normal(size=(n, 3))
    # the reference geometry with its symmetric atoms swapped, plus noise
    autos = tdmae.graph_automorphisms(bond, types)
    pos_gen = pos_ref[autos[-1]] + 0.05 * rng.normal(size=(n, 3))
    v, m = tdmae.get_min_dmae_match(pos_ref, pos_gen, autos)
    vr, mr = jdmae.get_min_dmae_match(pos_ref, pos_gen, autos)
    assert abs(v - vr) <= 1e-12
    np.testing.assert_array_equal(m, mr)
    graph = {"atom_type": types, "pos": pos_ref, "bond_mat": bond}
    for use in (True, False):
        assert abs(tdmae.dmae_for_graph(graph, pos_gen, use)
                   - jdmae.dmae_for_graph(graph, pos_gen, use)) <= 1e-12
    # matched below or at the identity's value; strictly below where symmetric atoms moved
    ident = tdmae.calc_dmae(pos_ref, pos_gen)
    assert v <= ident
    if len(autos) > 1:
        assert v < ident


def test_graph_dmae_from_edge_lists_equals_the_reference():
    bond, types = benzene_ring()
    ei = np.array(np.nonzero(bond))
    graph = {"atom_type": types, "pos": np.random.default_rng(0).normal(size=(6, 3)),
             "edge_index": ei, "edge_type": bond[ei[0], ei[1]]}
    pos_gen = np.random.default_rng(1).normal(size=(6, 3))
    assert abs(tdmae.dmae_for_graph(graph, pos_gen) - jdmae.dmae_for_graph(graph, pos_gen)) <= 1e-12


def test_synthetic_corpus_equals_the_reference():
    """Seeded synthetic reactions (``data/synthetic.py``) with noisy
    generated geometries: the same automorphisms and D-MAE per reaction, the
    matched value never above the identity's."""
    corpus = make_corpus(40, seed=11)
    rng = np.random.default_rng(12)
    for g in corpus:
        n = len(g["atom_type"])
        pos_gen = g["pos"] + rng.normal(scale=0.3, size=(n, 3))
        assert_same_autos(np.asarray(g["bond_mat"]), g["atom_type"])
        mine = tdmae.dmae_for_graph(g, pos_gen)
        assert abs(mine - jdmae.dmae_for_graph(g, pos_gen)) <= 1e-12
        assert mine <= tdmae.calc_dmae(g["pos"], pos_gen)
