"""Conformer evaluation of the port against the JAX package (numpy and
scipy on both sides): the Kabsch and mirror alignment, the clustering of a
reaction's conformers and its CLI, COV/MAT and the evaluate CLI's
``--covmat``, the legacy conformer datasets and the synthetic conformer
corpus they are fed here.  Equal means equal to the last bit unless a test
says otherwise: both packages run the same numpy operations.
"""

import os
import pickle
import sys

import numpy as np
import pytest

from tsdiff_tpu.cli import clustering as jax_clustering_cli
from tsdiff_tpu.cli import evaluate as jax_evaluate_cli
from tsdiff_tpu.data import legacy as jlegacy
from tsdiff_tpu.eval import align as jalign
from tsdiff_tpu.eval import clustering as jclustering
from tsdiff_tpu.eval import covmat as jcovmat

from tsdiff_tpu_torch.cli import clustering as clustering_cli
from tsdiff_tpu_torch.cli import evaluate as evaluate_cli
from tsdiff_tpu_torch.data import legacy
from tsdiff_tpu_torch.data.synthetic import conformers_of, make_conformer_corpus, make_molecule
from tsdiff_tpu_torch.eval import align, clustering, covmat


def rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def test_synthetic_conformer_corpus():
    graphs = make_conformer_corpus(8, seed=0, conformers=4)
    assert len(graphs) == 32
    again = make_conformer_corpus(8, seed=0, conformers=4)
    for g, h in zip(graphs, again):
        np.testing.assert_array_equal(g["pos"], h["pos"])
    for i in range(8):
        mol = graphs[4 * i: 4 * i + 4]
        n = len(mol[0]["atom_type"])
        assert 9 <= n <= 29 and len({g["smiles"] for g in mol}) == 1
        g = mol[0]
        assert g["r_feat"].shape == g["p_feat"].shape == (n, 0)
        assert (g["atom_type"] == 1).sum() > 0 and set(g["atom_type"]) <= {1, 6, 7, 8}
        ei, et = g["edge_index"], g["edge_type"]
        assert set(et.tolist()) <= {1, 2} and ei.shape == (2, len(et))
        bond = np.zeros((n, n), int)
        bond[ei[0], ei[1]] = et
        np.testing.assert_array_equal(bond, bond.T)
        assert (bond[g["atom_type"] == 1] > 0).sum(1).max() == 1   # H bonds once
        d = [np.linalg.norm(c["pos"][:, None] - c["pos"][None], axis=-1) for c in mol]
        assert 0.05 < np.abs(d[0] - d[1]).mean() < 0.5


def test_alignment_matches_jax():
    rng = np.random.default_rng(1)
    ref = rng.normal(size=(9, 3))
    prb = (ref + rng.normal(scale=0.2, size=ref.shape)) @ rotation(rng) + 3.0
    mirrored = ref @ align.MIRROR
    for p in (prb, mirrored):
        np.testing.assert_array_equal(align.kabsch_align(ref, p), jalign.kabsch_align(ref, p))
        np.testing.assert_array_equal(align.rotate_transform_mirror(ref, p),
                                      jalign.rotate_transform_mirror(ref, p))
    assert align.rmsd(ref, prb) == jalign.rmsd(ref, prb)
    np.testing.assert_allclose(align.rotate_transform_mirror(ref, mirrored), ref, atol=1e-8)
    for a, b in zip(align.position_align(ref, [prb, mirrored]),
                    jalign.position_align(ref, [prb, mirrored])):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def reaction_conformers():
    """Ten conformers of one synthetic molecule of 9 atoms, in two groups,
    their atom order shuffled within the molecule's automorphisms."""
    rng = np.random.default_rng(2)
    mol = make_molecule(rng, 0)
    while len(mol["atom_type"]) > 12:
        mol = make_molecule(rng, 0)
    other = dict(mol, pos=mol["pos"] + rng.normal(scale=0.6, size=mol["pos"].shape))
    confs = conformers_of(rng, mol, 5, scale=0.01) + conformers_of(rng, other, 5, scale=0.01)
    matches = jclustering.matches_for(mol)
    for c in confs[1::2]:
        c["pos"] = c["pos"][np.asarray(matches[-1])]
    return mol, [np.asarray(c["pos"], np.float64) for c in confs]


def test_clustering_functions_match_jax(reaction_conformers):
    mol, pos = reaction_conformers
    matches = clustering.matches_for(mol)
    assert matches == jclustering.matches_for(mol) and len(matches) > 1
    assert clustering.pairwise_metric(pos[0], pos[1], matches) == \
        jclustering.pairwise_metric(pos[0], pos[1], matches)
    got = clustering.cluster_conformers(pos, matches, thresh=0.1)
    want = jclustering.cluster_conformers(pos, matches, thresh=0.1)
    assert got["num_clusters"] == want["num_clusters"] == 2
    for k in ("clusters", "linkage", "dist_mat"):
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(clustering.align_cluster(pos[:5], matches),
                    jclustering.align_cluster(pos[:5], matches)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("groups", [1, 3, 5])
def test_cluster_conformers_finds_known_groups(groups):
    """An ensemble built as G tight groups around G distinct geometries
    gives G clusters, each group one of them."""
    rng = np.random.default_rng(3 + groups)
    mol = make_molecule(rng, 0)
    confs, labels = [], []
    for g in range(groups):
        base = dict(mol, pos=mol["pos"] + rng.normal(scale=0.8, size=mol["pos"].shape))
        confs += [c["pos"] for c in conformers_of(rng, base, 4, scale=0.005)]
        labels += [g] * 4
    stat = clustering.cluster_conformers(confs, [tuple(range(len(mol["atom_type"])))], 0.1)
    assert stat["num_clusters"] == groups
    pairs = {(lab, c) for lab, c in zip(labels, stat["clusters"])}
    assert len(pairs) == groups


def test_covmat_functions_match_jax():
    rng = np.random.default_rng(4)
    graphs = make_conformer_corpus(3, seed=4, conformers=3)
    data = []
    for i in range(3):
        g = dict(graphs[3 * i])
        ref = np.stack([c["pos"] for c in graphs[3 * i: 3 * i + 3]])
        gen = np.concatenate([ref @ rotation(rng), ref + rng.normal(scale=0.3, size=ref.shape)])
        g.update(pos_ref=ref, pos_gen=gen)
        data.append(g)
    d0 = data[0]
    heavy = d0["atom_type"] != 1
    assert covmat.best_rmsd_numpy(d0["pos_gen"][0], d0["pos_ref"][0]) < 1e-6
    assert covmat.best_rmsd_numpy(d0["pos_gen"][4], d0["pos_ref"][1], heavy_mask=heavy) == \
        jcovmat.best_rmsd_numpy(d0["pos_gen"][4], d0["pos_ref"][1], heavy_mask=heavy)
    np.testing.assert_array_equal(covmat.rmsd_confusion_matrix(d0),
                                  jcovmat.rmsd_confusion_matrix(d0))
    assert covmat.evaluate_conf(d0, threshold=0.2) == jcovmat.evaluate_conf(d0, threshold=0.2)
    for workers in (1, 2):
        got = covmat.CovMatEvaluator(num_workers=workers, print_fn=lambda *_: None)(data)
        want = jcovmat.CovMatEvaluator(num_workers=1, print_fn=lambda *_: None)(data)
        for k in ("CoverageR", "MatchingR", "CoverageP", "MatchingP", "thresholds"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    lines, jlines = [], []
    covmat.print_covmat_results(got, print_fn=lines.append)
    jcovmat.print_covmat_results(want, print_fn=jlines.append)
    assert lines == jlines


def test_covmat_self_check_and_rdmol_branch(monkeypatch):
    """The reference stacks scored against themselves: COV 1 at every
    threshold, MAT ~ 0.  An RDKit ``rdmol`` takes RDKit's route
    (``tests/test_torch_chem_rdkit.py``), in the port as in the JAX package:
    where RDKit cannot be imported, both raise ImportError."""
    graphs = make_conformer_corpus(2, seed=5, conformers=3)
    data = []
    for i in range(2):
        ref = np.stack([c["pos"] for c in graphs[3 * i: 3 * i + 3]])
        data.append(dict(graphs[3 * i], pos_ref=ref, pos_gen=np.concatenate([ref, ref])))
    res = covmat.CovMatEvaluator(num_workers=1, print_fn=lambda *_: None)(data)
    assert (res.CoverageR == 1.0).all() and (res.CoverageP == 1.0).all()
    assert res.MatchingR.max() < 1e-6 and res.MatchingP.max() < 1e-6
    monkeypatch.setitem(sys.modules, "rdkit", None)
    for fn in (covmat.rmsd_confusion_matrix, jcovmat.rmsd_confusion_matrix):
        with pytest.raises(ImportError, match="rdkit"):
            fn(dict(data[0], rdmol=object()))


def test_legacy_datasets_match_jax(tmp_path):
    from tsdiff_tpu_torch.data import save_dataset

    graphs = make_conformer_corpus(4, seed=6, conformers=3)
    path = str(tmp_path / "conf.pkl")
    save_dataset(path, graphs)
    for src in (graphs, path):
        ds, jds = legacy.ConformationDataset(src), jlegacy.ConformationDataset(src)
        assert ds.atom_types == jds.atom_types and 1 in ds.atom_types
        assert ds.edge_types == jds.edge_types
        ps, jps = legacy.PackedConformationDataset(src), jlegacy.PackedConformationDataset(src)
        assert len(ps) == len(jps) == 4
        for g, h in zip(ps.graphs, jps.graphs):
            assert g["smiles"] == h["smiles"] and g["num_pos_ref"] == h["num_pos_ref"] == 3
            np.testing.assert_array_equal(g["pos_ref"], h["pos_ref"])


def test_rdkit_featurizers_need_rdkit():
    from tsdiff_tpu_torch.chem import have_rdkit

    if have_rdkit():
        pytest.skip("RDKit is installed")
    for call in (lambda: legacy.rdmol_to_data(None),
                 lambda: legacy.preprocess_geom_dataset(".", "qm9"),
                 lambda: legacy.preprocess_iso17_dataset(".")):
        with pytest.raises(ImportError, match="needs RDKit"):
            call()


def _samples(tmp_path, k=6):
    """A samples pickle as the sampling CLI writes it for a conformer test
    set repeated ``k`` times: one smiles, ``k`` generated conformers."""
    rng = np.random.default_rng(7)
    mol = make_molecule(rng, 3)
    while len(mol["atom_type"]) > 12:
        mol = make_molecule(rng, 3)
    results = []
    for c in conformers_of(rng, mol, k, scale=0.2):
        results.append(dict(mol, pos_gen=c["pos"]))
    results.append(dict(make_molecule(rng, 4), pos_gen=np.zeros((1, 3))))
    path = str(tmp_path / "samples_all.pkl")
    with open(path, "wb") as f:
        pickle.dump(results, f)
    return path, results


def test_clustering_cli_matches_jax(tmp_path, capsys):
    path, _ = _samples(tmp_path)
    out = {}
    for name, cli in (("port", clustering_cli), ("jax", jax_clustering_cli)):
        d = str(tmp_path / name)
        cli.main(["--sample_path", path, "--save_dir", d, "--thresh", "0.3"])
        out[name] = (d, capsys.readouterr().out)
    assert out["port"][1] == out["jax"][1]
    files = sorted(os.listdir(out["port"][0]))
    assert files == sorted(os.listdir(out["jax"][0])) and "stat_clustering.pkl" in files
    for f in files:
        if f.endswith(".png"):
            continue
        a, b = (os.path.join(out[n][0], f) for n in ("port", "jax"))
        if f.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                sa, sb = pickle.load(fa), pickle.load(fb)
            assert sa["num_clusters"] == sb["num_clusters"] >= 1
            np.testing.assert_array_equal(sa["cluster"], sb["cluster"])
            np.testing.assert_array_equal(sa["dist_mat"], sb["dist_mat"])
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read()
    with pytest.raises(ValueError, match="--force"):
        clustering_cli.main(["--sample_path", path, "--save_dir", out["port"][0]])
    clustering_cli.main(["--sample_path", path, "--save_dir", out["port"][0], "--force"])


def test_evaluate_cli_covmat_matches_jax(tmp_path, capsys):
    """Conformers grouped by smiles with their ``pos_ref`` stacks, as the
    JAX package's ``test_cli_end_to_end.py`` feeds ``--covmat``: the same
    printed table and results."""
    graphs = make_conformer_corpus(3, seed=8, conformers=2)
    rng = np.random.default_rng(8)
    packed = []
    for g in legacy.PackedConformationDataset(graphs).graphs:
        ref = g["pos_ref"]
        packed.append(dict(g, pos_gen=np.concatenate([ref, ref]) + rng.normal(
            scale=0.1, size=(4, *ref.shape[1:])).astype(np.float32)))
    path = str(tmp_path / "packed.pkl")
    with open(path, "wb") as f:
        pickle.dump(packed, f)
    stats = evaluate_cli.main(["--samples", path, "--covmat"])
    text = capsys.readouterr().out
    jstats = jax_evaluate_cli.main(["--samples", path, "--covmat"])
    assert text == capsys.readouterr().out
    assert "MAT-R_mean" in text and stats["covmat"].CoverageR.shape[0] == 3
    for k in ("CoverageR", "MatchingR", "CoverageP", "MatchingP"):
        np.testing.assert_array_equal(getattr(stats["covmat"], k), getattr(jstats["covmat"], k))
