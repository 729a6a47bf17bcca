"""The check that no module of JAX or of the JAX package is loaded compares
top-level names whole, and a cell's run loads none."""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import common  # noqa: E402

ROOT = common.ROOT


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tsdiff_tpu_torch_lookalike", sys)
    for name in common.FORBIDDEN_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert "tsdiff_tpu_torch_lookalike" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "tsdiff_tpu.cli", sys)
    assert common.forbidden_modules() == ["jax", "tsdiff_tpu"]


def test_a_cells_modules_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run, portbench.walk, portbench.calibrate, portbench.trace\n"
            "import portbench.reference.check, portbench.layers\n"
            "import tsdiff_tpu_torch.diffusion.captured, tsdiff_tpu_torch.diffusion.ensemble\n"
            "import tsdiff_tpu_torch.diffusion.dual_objective, tsdiff_tpu_torch.core.graph\n"
            "import tsdiff_tpu_torch.utils.compile_cache, tsdiff_tpu_torch.models\n"
            "from portbench import common\n"
            "print(common.forbidden_modules())\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            with open(os.path.join(ref, name)) as f:
                text = f.read()
            assert "tsdiff_tpu" not in text and "import jax" not in text, name
