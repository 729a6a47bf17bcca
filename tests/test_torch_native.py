"""The port's native batch packer (``tsdiff_tpu_torch/data/native.py`` over
``csrc/graphbuild.cpp``) against the JAX package's binding of the same C++
(``tsdiff_tpu/data/native.py``) and against the port's numpy packer
(``core/graph.py::pack_numpy``): equal arrays bit for bit, the oversized
graph's error, the dispatch on the input's form (sparse edges native, a
dense ``bond_mat`` numpy), and the build: keyed by the source's hash into
``tsdiff_tpu_torch/_build/``, a failed build raising with the compiler's
output, never a fallback."""

import os

import numpy as np
import pytest
import torch

from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.data.native import pack_batch_native as jax_pack_batch_native

from tsdiff_tpu_torch.core.graph import from_numpy_graphs, pack_numpy
from tsdiff_tpu_torch.data import native
from tsdiff_tpu_torch.data.dataset import _empty_graph
from tsdiff_tpu_torch.data.synthetic import make_corpus, sparse_edges

from test_data import make_graph_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("atom_type", "r_feat", "p_feat", "pos", "bond_mat", "node_mask")


def graph_sets():
    """Sparse-edge graph lists: the JAX tests' random graphs (4-9 atoms,
    N=12), the synthetic corpus at the training and sampling shapes with
    zero-atom padding graphs and a graph without positions."""
    rng = np.random.default_rng(0)
    corpus = sparse_edges(make_corpus(40, seed=5))
    no_pos = dict(corpus[0], pos=None)
    return {
        "random": (make_graph_dicts(rng, [4, 7, 9, 3]), 12),
        "corpus_n24": (corpus[:30] + [_empty_graph(25)] * 2 + [no_pos], 24),
        "corpus_n16": ([g for g in corpus if len(g["atom_type"]) <= 16], 16),
    }


@pytest.mark.parametrize("name", ["random", "corpus_n24", "corpus_n16"])
def test_native_packer_equals_the_jax_binding(name):
    graphs, n = graph_sets()[name]
    want = jax_pack_batch_native(graphs, n)
    assert want is not None, "the JAX package's native library did not build"
    got = native.pack_batch_native(graphs, n)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["random", "corpus_n24", "corpus_n16"])
def test_from_numpy_graphs_native_equals_numpy_and_jax(name, monkeypatch):
    graphs, n = graph_sets()[name]
    calls = []
    real = native.pack_batch_native
    monkeypatch.setattr(native, "pack_batch_native",
                        lambda *a: calls.append(1) or real(*a))
    batch = from_numpy_graphs(graphs, max_nodes=n)
    assert calls == [1]
    plain = pack_numpy(graphs, n)
    jb = jax_from_numpy_graphs(graphs, max_nodes=n)
    for f in FIELDS:
        got = getattr(batch, f).numpy()
        assert got.dtype == plain[f].dtype
        np.testing.assert_array_equal(got, plain[f])
        np.testing.assert_array_equal(got, np.asarray(getattr(jb, f)))


def test_dense_bond_mat_takes_the_numpy_packer(monkeypatch):
    """The dispatch is on the input's form: the same graphs with a dense
    ``bond_mat`` never reach the C++ packer and pack to the same batch."""
    graphs = make_corpus(6, seed=2)
    sparse = from_numpy_graphs(sparse_edges(graphs), max_nodes=24)
    monkeypatch.setattr(native, "pack_batch_native",
                        lambda *a: pytest.fail("a dense bond_mat reached the C++ packer"))
    dense = from_numpy_graphs(graphs, max_nodes=24)
    for f in FIELDS:
        assert torch.equal(getattr(dense, f), getattr(sparse, f))


def test_oversized_graph_keeps_its_error():
    graphs = sparse_edges(make_corpus(30, seed=4))
    big = max(graphs, key=lambda g: len(g["atom_type"]))
    n = len(big["atom_type"])
    with pytest.raises(ValueError, match=f"graph with {n} atoms exceeds max_nodes={n - 1}"):
        from_numpy_graphs([graphs[0], big], max_nodes=n - 1)
    with pytest.raises(ValueError, match=f"graph with {n} atoms exceeds max_nodes={n - 1}"):
        pack_numpy([big], n - 1)
    with pytest.raises(ValueError, match="pack_batch failed"):
        native.pack_batch_native([big], n - 1)
    # an edge leaving its graph is refused by the C++ packer too
    bad = dict(graphs[0], edge_index=np.array([[0], [len(graphs[0]["atom_type"])]], np.int32),
               edge_type=np.array([5], np.int32))
    with pytest.raises(ValueError, match="outside its graph"):
        native.pack_batch_native([bad], 24)


def test_library_is_keyed_by_the_source_in_the_port_build_dir(tmp_path, monkeypatch):
    path = native.library_path()
    assert os.path.dirname(os.path.dirname(path)) == os.path.join(REPO, "tsdiff_tpu_torch",
                                                                  "_build")
    assert native.native_available() and os.path.exists(path)
    edited = tmp_path / "graphbuild.cpp"
    edited.write_text(open(native.SOURCE).read() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(edited))
    assert native.library_path() != path


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "graphbuild.cpp"
    broken.write_text("int pack_batch( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"failed \(exit [1-9]") as e:
        native.build()
    assert "error" in str(e.value)
    with pytest.raises(RuntimeError):
        native.pack_batch_native(make_graph_dicts(np.random.default_rng(0), [4]), 8)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
