"""The port's protein data path (``tsdiff_tpu_torch.data.pdb``,
``eval/protein.py``, the batch's ``is_sidechain``, ``preprocessing
--pdb_glob``, ``evaluate --protein``) against the JAX package's: numpy
modules equal to the bit, on the inline PDB texts of ``tests/test_pdb.py``,
the gate's ``res_chain`` and the port's compact synthetic protein."""

import pickle

import numpy as np
import pytest
import torch

import tsdiff_tpu.data.pdb as jpdb
import tsdiff_tpu.eval.protein as jprot
import tsdiff_tpu_torch.data.pdb as tpdb
import tsdiff_tpu_torch.eval.protein as tprot
from test_pdb import _atom_line, _protein_chain, dipeptide_pdb
from test_protein_gate import res_chain
from tsdiff_tpu_torch.data.synthetic import compact_protein_pdb, pdb_atom_line
from tsdiff_tpu_torch.data.synthetic import res_chain as port_res_chain


def _equal(a, b, where=""):
    """Graph dicts (or any nesting of arrays, lists, scalars) equal exactly,
    key for key and dtype for dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _insertion_pdb():
    rows = [("N", "ALA", (0.0, 0.0, 0.0), "N", " "), ("CA", "ALA", (1.46, 0.0, 0.0), "C", " "),
            ("C", "ALA", (2.0, 1.4, 0.0), "C", " "), ("O", "ALA", (1.3, 2.4, 0.0), "O", " "),
            ("CB", "ALA", (2.0, -0.8, -1.2), "C", " "), ("N", "SER", (3.3, 1.5, 0.0), "N", "A"),
            ("CA", "SER", (4.0, 2.8, 0.0), "C", "A"), ("C", "SER", (5.5, 2.6, 0.1), "C", "A"),
            ("O", "SER", (6.1, 1.6, -0.3), "O", "A"), ("CB", "SER", (3.6, 3.6, 1.25), "C", "A"),
            ("OG", "SER", (2.2, 3.8, 1.3), "O", "A")]
    lines = []
    for i, (nm, rn, xyz, el, ic) in enumerate(rows):
        line = _atom_line(i + 1, nm, rn, "A", 100, *xyz, el)
        lines.append(line[:26] + ic + line[27:])
    return "\n".join(lines)


def _messy_pdb():
    ca = _atom_line(3, "CA", "ALA", "A", 1, 1.4, 0, 0, "C")
    return "\n".join([
        "HEADER    TEST", _atom_line(1, "N", "ALA", "A", 1, 0, 0, 0, "N"),
        _atom_line(2, "H", "ALA", "A", 1, 0.5, 0.5, 0, "H"), ca[:16] + "B" + ca[17:],
        _atom_line(4, "CA", "ALA", "A", 1, 1.45, 0, 0, "C"),
        "HETATM    5  O   HOH A 201      9.000   9.000   9.000  1.00  0.00           O",
        _atom_line(6, "C", "ALA", "A", 1, 2.1, 1.2, 0, "C")[:76] + "  ",
        _atom_line(7, "O", "ALA", "A", 1, 1.6, 2.3, 0, "O"),
        _atom_line(8, "CB", "ALA", "A", 1, 1.8, -0.9, 1.2, "C"), "ENDMDL",
        _atom_line(9, "N", "GLY", "A", 2, 50, 50, 50, "N")])


def _gly_pdb():
    rows = [("N", (0, 0, 0), "N"), ("CA", (1.5, 0, 0), "C"), ("C", (2, 1.4, 0), "C"),
            ("O", (1.3, 2.4, 0), "O")]
    return "\n".join(_atom_line(i + 1, n, "GLY", "A", 1, *xyz, el)
                     for i, (n, xyz, el) in enumerate(rows))


TEXTS = {
    "dipeptide": dipeptide_pdb,
    "insertion": _insertion_pdb,
    "messy": _messy_pdb,
    "gly_only": _gly_pdb,
    "ala_chain": lambda: _protein_chain(8, seed=1),
    "gate_chain": lambda: res_chain(8, seed=7),
    "compact": lambda: compact_protein_pdb(40, seed=3),
}


def test_synthetic_texts_equal_the_tests():
    assert port_res_chain(8, seed=7) == res_chain(8, seed=7)
    assert pdb_atom_line(3, "OG1", "THR", "B", 12, 1.5, -2.25, 3.0, "O") == \
        _atom_line(3, "OG1", "THR", "B", 12, 1.5, -2.25, 3.0, "O")


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_and_graph_equal_jax(name):
    text = TEXTS[name]()
    a, b = tpdb.parse_pdb(text), jpdb.parse_pdb(text)
    for f in ("name", "resname", "chain", "resnum", "icode", "element", "pos"):
        _equal(getattr(a, f), getattr(b, f), f)
    g = tpdb.pdb_to_graph(text, name=name)
    ref = jpdb.pdb_to_graph(text, name=name)
    if ref is None:
        assert g is None and name == "gly_only"
        return
    _equal(g, ref, name)


def test_subgraphs_equal_jax():
    g = tpdb.pdb_to_graph(compact_protein_pdb(40, seed=3))
    for cutoff, fix in ((6.0, False), (10.0, False), (10.0, True)):
        a = tpdb.sample_sidechain_subgraph(g, np.random.default_rng(5), cutoff, fix)
        b = jpdb.sample_sidechain_subgraph(g, np.random.default_rng(5), cutoff, fix)
        _equal(a, b, f"subgraph {cutoff} {fix}")
    for seed in (0, 1):
        a = tpdb.cover_protein_with_subgraphs(g, np.random.default_rng(seed), 7.0)
        b = jpdb.cover_protein_with_subgraphs(g, np.random.default_rng(seed), 7.0)
        _equal(a, b, "cover")
        assert len(a) > 1
    da = tpdb.SidechainConformationDataset([g, None, g], cutoff=8.0, seed=11)
    db = jpdb.SidechainConformationDataset([g, None, g], cutoff=8.0, seed=11)
    assert len(da) == len(db) == 2
    _equal([da[i % 2] for i in range(5)], [db[i % 2] for i in range(5)], "dataset")
    subs = [da[0], da[1]]
    _equal(tpdb.pack_sidechain_mask(subs, 200), jpdb.pack_sidechain_mask(subs, 200), "mask")


def test_write_pdb_equal_jax_and_round_trips():
    g = tpdb.pdb_to_graph(_insertion_pdb())
    pos = g["pos"] + 0.25
    assert tpdb.write_pdb(g, pos) == jpdb.write_pdb(g, pos)
    g2 = tpdb.pdb_to_graph(tpdb.write_pdb(g))
    np.testing.assert_allclose(g2["pos"], g["pos"], atol=1e-3)
    _equal(g2["edge_index"], g["edge_index"])
    _equal(g2["icode"], g["icode"])
    with pytest.raises(ValueError):
        tpdb.write_pdb({k: v for k, v in g.items() if k != "atom_name"})


def test_eval_protein_equal_jax():
    g = tpdb.pdb_to_graph(compact_protein_pdb(40, seed=4))
    rng = np.random.default_rng(0)
    pos = g["pos"] + rng.normal(scale=0.8, size=g["pos"].shape).astype(np.float32)
    cov = rng.integers(0, 3, size=len(pos))
    _equal(tprot.chi1_quads(g), jprot.chi1_quads(g))
    quads = tprot.chi1_quads(g)
    assert len(quads) > 10
    _equal(tprot.dihedral_deg(pos, quads), jprot.dihedral_deg(pos, quads))
    a, b = rng.uniform(-360, 360, 50), rng.uniform(-360, 360, 50)
    _equal(tprot.angular_diff_deg(a, b), jprot.angular_diff_deg(a, b))
    for c in (None, cov):
        _equal(tprot.rotamer_distribution(pos, g, c), jprot.rotamer_distribution(pos, g, c))
        _equal(tprot.chi1_accuracy(pos, g["pos"], g, 30.0, c),
               jprot.chi1_accuracy(pos, g["pos"], g, 30.0, c))
    args = ([0.0, 0, 0], [1.4, 0, 0], [2.1, 1.2, 0], 1.53, 110.5, 122.0)
    _equal(tprot.place_dihedral(*args), jprot.place_dihedral(*args))


@pytest.mark.parametrize("native", [True, False])
def test_batch_mask_equal_jax(native):
    """``from_numpy_graphs`` packs ``is_sidechain`` as JAX's does, through
    the C++ packer (sparse edges) and the numpy one (dense ``bond_mat``),
    on a tail batch padded with empty graphs; molecules get None."""
    from tsdiff_tpu.core.graph import from_numpy_graphs as jpack
    from tsdiff_tpu.data.dataset import _empty_graph as jempty
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data.dataset import _empty_graph

    g = tpdb.pdb_to_graph(compact_protein_pdb(24, seed=5))
    subs = tpdb.cover_protein_with_subgraphs(g, np.random.default_rng(0), 7.0)[:3]
    if not native:
        subs = [dict(s, bond_mat=_dense(s)) for s in subs]
    _equal(_empty_graph(0, sidechain=True), jempty(0))
    graphs = subs + [_empty_graph(0, sidechain=True)] * 2
    b = from_numpy_graphs(graphs, max_nodes=104)
    ref = jpack(graphs, max_nodes=104)
    assert b.is_sidechain.dtype == torch.bool
    np.testing.assert_array_equal(b.is_sidechain.numpy(), np.asarray(ref.is_sidechain))
    np.testing.assert_array_equal(b.bond_mat.numpy(), np.asarray(ref.bond_mat))
    assert not b.is_sidechain[~b.node_mask].any()
    mol = [{k: v for k, v in s.items() if k != "is_sidechain"} for s in subs]
    assert from_numpy_graphs(mol + [_empty_graph(0)], max_nodes=104).is_sidechain is None


def _dense(g):
    n = len(g["atom_type"])
    m = np.zeros((n, n), np.int64)
    m[g["edge_index"][0], g["edge_index"][1]] = g["edge_type"]
    return m


def test_batch_mask_moves_with_the_batch():
    """The prefetcher's transfer and the mesh's row split carry the mask."""
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data.prefetch import to_device
    from tsdiff_tpu_torch.parallel.sharding import Spec, take

    g = tpdb.pdb_to_graph(_protein_chain(6, seed=2))
    subs = tpdb.cover_protein_with_subgraphs(g, np.random.default_rng(0), 6.0)[:2]
    b = from_numpy_graphs(subs, max_nodes=40)
    moved = to_device(b, "cpu")
    assert torch.equal(moved.is_sidechain, b.is_sidechain)
    half = take(b, Spec(2, 1))
    assert torch.equal(half.is_sidechain, b.is_sidechain[1:])
    mol = from_numpy_graphs([{k: v for k, v in s.items() if k != "is_sidechain"}
                             for s in subs], max_nodes=40)
    assert to_device(mol, "cpu").is_sidechain is None


@pytest.mark.parametrize("sidechain", [True, False])
def test_rank_of_padding_keeps_the_batch_fields(sidechain):
    """A data-parallel rank's rows of a tail batch that are all padding
    carry the fields of the bucket's full batches: the mask on protein
    subgraphs, None on molecules, so that the bucket's captured step
    (recorded on the first batch) takes every later one."""
    from tsdiff_tpu_torch.data.dataset import PaddedBatchLoader
    from tsdiff_tpu_torch.diffusion.captured import copy_into

    g = tpdb.pdb_to_graph(_protein_chain(8, seed=3))
    subs = (tpdb.cover_protein_with_subgraphs(g, np.random.default_rng(0), 6.0) * 5)[:5]
    if not sidechain:
        subs = [{k: v for k, v in s.items() if k != "is_sidechain"} for s in subs]
    loader = PaddedBatchLoader(subs, batch_size=4, bucket_sizes=[64], with_indices=True,
                               rows=slice(2, 4))   # rank 1 of dp=2
    (full, idx_full), (tail, idx_tail) = list(loader)
    assert (idx_full >= 0).all() and (idx_tail[2:] == -1).all()   # rank 1: padding alone
    assert not tail.node_mask.any()
    assert (full.is_sidechain is not None) == (tail.is_sidechain is not None) == sidechain
    copy_into(full, tail)


def test_preprocessing_pdb_glob_equal_jax(tmp_path):
    from tsdiff_tpu.cli import preprocessing as jcli
    from tsdiff_tpu_torch.cli import preprocessing

    src = tmp_path / "pdbs"
    src.mkdir()
    (src / "a.pdb").write_text(_protein_chain(4, seed=0))
    (src / "b.pdb").write_text(compact_protein_pdb(20, seed=1))
    (src / "c.pdb").write_text(_gly_pdb())
    out = preprocessing.main(["--pdb_glob", str(src / "*.pdb"), "--save_dir",
                              str(tmp_path / "port")])
    ref = jcli.main(["--pdb_glob", str(src / "*.pdb"), "--save_dir", str(tmp_path / "jax")])
    assert out.endswith("proteins.pkl") and ref.endswith("proteins.pkl")
    with open(out, "rb") as f, open(ref, "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert len(a["graphs"]) == 2
    _equal(a, b, "proteins.pkl")
    with pytest.raises(SystemExit):
        preprocessing.main(["--pdb_glob", str(tmp_path / "none*.pdb")])


def test_evaluate_protein_equal_jax(tmp_path, capsys):
    from tsdiff_tpu.cli import evaluate as jcli
    from tsdiff_tpu_torch.cli import evaluate

    rng = np.random.default_rng(0)
    results = []
    for seed in (1, 2):
        g = tpdb.pdb_to_graph(compact_protein_pdb(20, seed=seed))
        n = len(g["atom_type"])
        cov = rng.integers(0, 2, size=n)
        results.append(dict(
            name=f"p{seed}", pos_gen=g["pos"] + rng.normal(scale=0.5, size=(n, 3)),
            pos_gt=g["pos"], is_sidechain=g["is_sidechain"], coverage_counts=cov,
            nan=seed == 2, atom_name=g["atom_name"], res_name=g["res_name"],
            atom2res=g["atom2res"]))
    results.append(dict(name="bare", pos_gen=np.zeros((3, 3)), pos_gt=np.zeros((3, 3)),
                        is_sidechain=np.array([0, 1, 0], bool), coverage_counts=np.zeros(3),
                        nan=True))
    path = tmp_path / "proteins_gen.pkl"
    path.write_bytes(pickle.dumps(results))
    stats = evaluate.main(["--samples", str(path), "--protein", "--out", str(tmp_path / "s.pkl")])
    out = capsys.readouterr().out
    ref = jcli.main(["--samples", str(path), "--protein", "--out", str(tmp_path / "r.pkl")])
    assert capsys.readouterr().out == out
    _equal(stats, ref, "stats")
    _equal(pickle.loads((tmp_path / "s.pkl").read_bytes()),
           pickle.loads((tmp_path / "r.pkl").read_bytes()), "stats pickle")
    assert stats["chi1_n"] > 0 and stats["nan_flagged"] == 2
