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
                 "train.trainer", "diffusion.objective", "models.schnet"):
        assert f"tsdiff_tpu_torch.{name}" in names
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.path.insert(0, {REPO!r})
for name in {names!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "tsdiff_tpu" or m.startswith("tsdiff_tpu."))
assert not bad, bad
assert "triton" not in sys.modules
print(len({names!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(names)
