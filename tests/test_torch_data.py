"""The port's data and eval helpers against their JAX-package twins: the
synthetic corpus generator, dataset I/O, shape buckets and tiers, D-MAE."""

import os
import sys

import numpy as np
import pytest

from tsdiff_tpu.data import dataset as jds
from tsdiff_tpu.eval import dmae as jdmae

from tsdiff_tpu_torch.data import dataset as tds
from tsdiff_tpu_torch.data import synthetic
from tsdiff_tpu_torch.eval import dmae as tdmae

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import make_synthetic_corpus  # noqa: E402


def test_bend_table_and_make_reaction_match_tools():
    np.testing.assert_array_equal(synthetic._bend_table(), make_synthetic_corpus._bend_table())
    table = synthetic._bend_table()
    rng_a, rng_b = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(20):
        a = synthetic.make_reaction(rng_a, table)
        b = make_synthetic_corpus.make_reaction(rng_b, table)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


def test_make_corpus_is_seeded():
    a, b = synthetic.make_corpus(5, seed=1), synthetic.make_corpus(5, seed=1)
    assert [g["smiles"] for g in a] == [g["smiles"] for g in b]
    assert all(6 <= len(g["atom_type"]) <= 23 for g in synthetic.make_corpus(50, seed=2))


def test_dataset_io_round_trips_with_jax_format(tmp_path):
    graphs = synthetic.make_corpus(4, seed=0)
    p = str(tmp_path / "d.pkl")
    tds.save_dataset(p, graphs, feat_dict={"x": 1})
    jg, jf = jds.load_dataset(p)            # the JAX package reads the port's file
    tg, tf = tds.load_dataset(p)
    assert jf == tf == {"x": 1}
    assert [g["smiles"] for g in tg] == [g["smiles"] for g in jg]
    q = str(tmp_path / "j.pkl")
    jds.save_dataset(q, graphs)             # and the port reads the JAX package's
    assert len(tds.load_dataset(q)[0]) == 4
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(__import__("pickle").dumps({"format": "other"}))
    with pytest.raises(ValueError):
        tds.load_dataset(str(bad))


@pytest.mark.parametrize("n", [1, 8, 9, 23, 24, 25])
def test_buckets_match(n):
    assert tds.default_buckets(n) == jds.default_buckets(n)
    buckets = tds.default_buckets(30)
    assert tds.pick_bucket(n, buckets) == jds.pick_bucket(n, buckets)


@pytest.mark.parametrize("base,dp,max_tiers", [(100, 1, 3), (100, 1, None), (64, 4, None), (6, 1, 3)])
def test_tier_ladder_matches(base, dp, max_tiers):
    assert tds.tier_ladder(base, dp, max_tiers) == jds.tier_ladder(base, dp, max_tiers)


def test_dmae_matches():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(9, 3)), rng.normal(size=(9, 3))
    perm = rng.permutation(9)
    np.testing.assert_array_equal(tdmae.distance_matrix(a), jdmae.distance_matrix(a))
    assert tdmae.calc_dmae(a, b) == jdmae.calc_dmae(a, b)
    assert tdmae.calc_dmae(a, b, perm) == jdmae.calc_dmae(a, b, perm)
    assert tdmae.calc_dmae(a, a) == 0.0


@pytest.mark.parametrize("shuffle", [True, False])
def test_padded_batch_loader_matches_jax(shuffle):
    """The same seeded plan over two epochs, the same padded tail batches and
    the same dataset indices (-1 for padding) as the JAX package's loader."""
    graphs = synthetic.make_corpus(23, seed=4)
    kw = dict(batch_size=4, shuffle=shuffle, seed=7, with_indices=True)
    jl = jds.PaddedBatchLoader(jds.TSDataset(graphs), **kw)
    tl = tds.PaddedBatchLoader(tds.TSDataset(graphs), **kw)
    assert tl.bucket_sizes == jl.bucket_sizes
    padded = False
    for _ in range(2):  # each epoch draws a new permutation from the loader's rng
        jbatches, tbatches = list(jl), list(tl)
        assert len(tbatches) == len(jbatches) > 1
        for (jb, ji), (tb, ti) in zip(jbatches, tbatches):
            np.testing.assert_array_equal(ti, ji)
            padded |= bool((ti == -1).any())
            for name in ("atom_type", "r_feat", "p_feat", "pos", "bond_mat", "node_mask"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                              np.asarray(getattr(jb, name)))
    assert padded
    loader = tds.PaddedBatchLoader(tds.TSDataset(graphs[:6]), 4)
    n = len(loader)
    it = tds.inf_iterator(loader)
    shapes = [tuple(next(it).atom_type.shape) for _ in range(2 * n)]
    assert shapes[:n] == shapes[n:]  # the second epoch follows the first
