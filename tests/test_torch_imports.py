"""Import guard: every tsdiff_tpu_torch module imports with JAX unavailable
and loads nothing of the JAX package."""

import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    import tsdiff_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(tsdiff_tpu_torch.__path__, "tsdiff_tpu_torch.")]
    for name in ("ops.packed_score", "ops.schnet_stack", "ops.condensed_score",
                 "ops.packed_score_int8", "cli.sampling", "cli.train",
                 "train.trainer", "diffusion.objective", "models.schnet",
                 "parallel", "parallel.sharding", "parallel.multihost", "data.native",
                 "eval.align", "eval.clustering", "eval.covmat", "cli.clustering",
                 "models.gin", "models.dualenc", "models.edge", "diffusion.dual_objective",
                 "data.legacy", "data.synthetic", "data.pdb", "eval.protein",
                 "diffusion.protein", "cli.protein_sampling", "ops.basis", "models.egnn",
                 "models.dimenetpp", "models.comenet"):
        assert f"tsdiff_tpu_torch.{name}" in names
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
sys.path.insert(0, {REPO!r})
for name in {names!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "tsdiff_tpu" or m.startswith("tsdiff_tpu."))
assert not bad, bad
assert "triton" not in sys.modules
assert "scipy" not in sys.modules
assert "sympy" not in sys.modules
print(len({names!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(names)


def test_native_packer_builds_into_the_port_build_dir():
    """With JAX unavailable, ``csrc/graphbuild.cpp`` builds (or is reused)
    under ``tsdiff_tpu_torch/_build/`` and packs a batch; the JAX package's
    ``native/build/`` is left as it was."""
    jax_build = os.path.join(REPO, "native", "build")

    def listing():
        if not os.path.isdir(jax_build):
            return None
        return sorted((n, os.stat(os.path.join(jax_build, n)).st_mtime_ns)
                      for n in os.listdir(jax_build))

    before = listing()
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.data import native
from tsdiff_tpu_torch.data.synthetic import make_corpus, sparse_edges
batch = from_numpy_graphs(sparse_edges(make_corpus(4, seed=0)), max_nodes=24)
assert batch.bond_mat.shape == (4, 24, 24)
bad = sorted(m for m in sys.modules if m == "tsdiff_tpu" or m.startswith("tsdiff_tpu."))
assert not bad, bad
print(native.library_path())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    path = out.stdout.strip()
    assert os.path.dirname(os.path.dirname(path)) == os.path.join(REPO, "tsdiff_tpu_torch",
                                                                  "_build")
    assert os.path.basename(path) == "libgraphbuild.so" and os.path.exists(path)
    assert listing() == before
