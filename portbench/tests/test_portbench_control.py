"""Each cell's control comes out not correct on the card, at the cell's own
size, on three seeds: the program's path in the precision below the
configuration's (the int8 score kernel for the bf16 ensemble, TF32 for the
float32 dual encoder) or, for bf16 training, which has no such path, the
reference with float8 products in its place.  Needs the card: run

    python -m pytest -m cuda portbench/tests/test_portbench_control.py

(``calibrate.py`` reads the same numbers for the limits.)"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import common  # noqa: E402

SEEDS = [2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs the cell at its own size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tsdiff8.campaign", "geodiff.conformers", "tsdiff.train"])
def test_control_is_not_correct(workload):
    need_card()
    import importlib

    from portbench.run import cache_environment

    cache_environment()
    from tsdiff_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    maybe_enable_compile_cache()
    spec = common.cell_spec(workload)
    read = importlib.import_module(f"portbench.{spec['traffic']['mode']}").calibration_readings
    for r in read(spec, SEEDS, control=True):
        assert any(r[n] > spec["limits"][n] for n in spec["limits"]), r


@pytest.mark.parametrize("workload,path", [
    ("tsdiff8.campaign", {"quant": "int8"}),
    ("geodiff.conformers", {"quant": "none", "tf32": True}),
])
def test_control_runs_the_path_its_traffic_names(workload, path):
    from portbench.walk import WalkCell

    spec = common.cell_spec(workload)
    assert WalkCell(spec, 1, "cpu", control=True).path == path
    assert WalkCell(spec, 1, "cpu").path == {"quant": "none"}
