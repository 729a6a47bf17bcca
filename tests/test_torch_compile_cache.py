"""The build cache behind ``TSDIFF_COMPILE_CACHE`` and the service's
``--compile_cache`` (``tsdiff_tpu_torch/utils/compile_cache.py``), on the CPU.

The flag, the environment variable and the default each give the build
roots of the CUDA kernels (``ops/_build.py``) and the C++ packer
(``data/native.py``); a root set after a library was loaded raises; the
CLIs and the service enable the cache at start-up; a second process finds
the packer the first one built in the cache and compiles nothing.  The
kernels' builds need nvcc and run on the card (``chip_smoke.py`` phase 15)."""

import os
import subprocess
import sys

import pytest

from tsdiff_tpu_torch import serve
from tsdiff_tpu_torch.data import native
from tsdiff_tpu_torch.ops import _build
from tsdiff_tpu_torch.utils import compile_cache
from tsdiff_tpu_torch.utils.compile_cache import enable_compile_cache, maybe_enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = os.path.join(REPO, "tsdiff_tpu_torch", "_build")


@pytest.fixture
def fresh(monkeypatch):
    """This process as if it had built and loaded nothing; the roots and the
    loaded libraries put back afterwards."""
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.setattr(native, "BUILD_ROOT", native.BUILD_ROOT)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    return monkeypatch


def test_default_roots_are_the_package_build_dir(fresh):
    assert compile_cache.build_roots() == {"kernels": DEFAULT, "packer": DEFAULT}
    assert maybe_enable_compile_cache() is False
    assert compile_cache.build_roots() == {"kernels": DEFAULT, "packer": DEFAULT}


def test_path_sets_both_roots_and_creates_them(fresh, tmp_path):
    cache = str(tmp_path / "cache" / "kernels")
    assert enable_compile_cache(cache) is True
    assert os.path.isdir(cache)
    assert compile_cache.build_roots() == {"kernels": cache, "packer": cache}
    assert _build._paths("packed_score")[1].startswith(cache + os.sep)
    assert native.library_path().startswith(cache + os.sep)


@pytest.mark.parametrize("given", ["flag", "env"])
def test_maybe_enable_reads_the_flag_then_the_environment(fresh, tmp_path, given):
    env, flag = str(tmp_path / "from_env"), str(tmp_path / "from_flag")
    fresh.setenv(compile_cache.ENV, env)
    assert maybe_enable_compile_cache(flag if given == "flag" else None) is True
    want = flag if given == "flag" else env
    assert compile_cache.build_roots() == {"kernels": want, "packer": want}


@pytest.mark.parametrize("loaded", ["kernels", "packer"])
def test_a_root_set_after_a_library_was_loaded_raises(fresh, tmp_path, loaded):
    if loaded == "kernels":
        fresh.setattr(_build, "_loaded", {"packed_score": object()})
    else:
        fresh.setattr(native, "_lib", object())
    with pytest.raises(RuntimeError, match=f"the {loaded} library was already loaded from"):
        enable_compile_cache(str(tmp_path / "late"))
    assert compile_cache.build_roots() == {"kernels": DEFAULT, "packer": DEFAULT}
    # the root it was loaded from is no change
    assert enable_compile_cache(DEFAULT) is True


def test_service_accepts_compile_cache_and_enables_it(fresh, tmp_path):
    """``--compile_cache`` parses (it was refused before the cache was
    ported) and ``serve.main`` enables it before anything is built: a
    service that cannot load its checkpoint fails after the roots moved."""
    cache = str(tmp_path / "served")
    args = serve.parse_args(["missing.ckpt", "--compile_cache", cache, "--device", "cpu"])
    assert args.compile_cache == cache
    with pytest.raises(FileNotFoundError):
        serve.main(["missing.ckpt", "--compile_cache", cache, "--device", "cpu"])
    assert compile_cache.build_roots() == {"kernels": cache, "packer": cache}


@pytest.mark.parametrize("cli", ["sampling", "protein_sampling", "train"])
def test_clis_enable_the_cache_from_the_environment(fresh, tmp_path, cli):
    """Each CLI moves the roots at start-up, before it reads its inputs
    (missing here, so it stops right after)."""
    import importlib

    cache = str(tmp_path / cli)
    fresh.setenv(compile_cache.ENV, cache)
    module = importlib.import_module(f"tsdiff_tpu_torch.cli.{cli}")
    argv = {"sampling": ["missing.ckpt", "--test_set", str(tmp_path / "none.pkl"),
                         "--save_dir", str(tmp_path / "out"), "--device", "cpu"],
            "protein_sampling": ["missing.ckpt", "--protein_set", str(tmp_path / "none.pkl"),
                                 "--save_dir", str(tmp_path / "out"), "--device", "cpu"],
            "train": [str(tmp_path / "missing.json"), "--logdir", str(tmp_path / "logs"),
                      "--device", "cpu"]}[cli]
    with pytest.raises((FileNotFoundError, OSError)):
        module.main(argv)
    assert compile_cache.build_roots() == {"kernels": cache, "packer": cache}


def test_second_process_reuses_the_packer_built_in_the_cache(tmp_path):
    """Two processes with ``TSDIFF_COMPILE_CACHE`` set: the first builds the
    packer into the cache, the second loads it without compiling; the
    package's own build directory is not touched."""
    cache = str(tmp_path / "cache")
    code = f"""
import os, sys
sys.path.insert(0, {REPO!r})
from tsdiff_tpu_torch.utils.compile_cache import maybe_enable_compile_cache
assert maybe_enable_compile_cache()
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.data import native
from tsdiff_tpu_torch.data.synthetic import make_corpus, sparse_edges
so = native.library_path()
built = not os.path.exists(so)
batch = from_numpy_graphs(sparse_edges(make_corpus(3, seed=0)), max_nodes=24)
assert batch.bond_mat.shape == (3, 24, 24)
print(so, built, os.stat(so).st_mtime_ns)
"""

    def listing():
        return sorted((n, os.stat(os.path.join(DEFAULT, n)).st_mtime_ns)
                      for n in os.listdir(DEFAULT)) if os.path.isdir(DEFAULT) else None

    before = listing()
    env = {**os.environ, compile_cache.ENV: cache}
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=300, env=env)
        assert out.returncode == 0, out.stderr
        so, built, mtime = out.stdout.split()
        runs.append((so, built == "True", int(mtime)))
    assert runs[0][0] == runs[1][0] and runs[0][0].startswith(cache + os.sep)
    assert runs[0][1] and not runs[1][1] and runs[0][2] == runs[1][2]
    assert listing() == before
