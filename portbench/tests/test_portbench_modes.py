"""The sampling modes of the four-card campaign and of DimeNet++, rehearsed
on the CPU at tiny sizes: the mesh walk over four Gloo ranks
(``walk_mesh.py``) and the DimeNet++ walk (``walk_dimenet.py``) each read
``correct`` true against their references; DimeNet++'s cost counts and its
readers."""

import copy
import os
import pickle
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import common, run  # noqa: E402
from portbench.costs import dimenetpp as costs  # noqa: E402

TINY = {"kind": "normal", "mean": 8.0, "sd": 1.5, "min": 6, "max": 10}
END_TO_END = [{"name": "samples_per_s", "unit": "samples/s"}, {"name": "setup_s", "unit": "s"}]


def tiny_traffic(name: str, **over) -> dict:
    tr = common.load_json("traffic", f"{name}.json")
    tr.update(shard=8, shards=2, batch=4, respacing=6, sizes=TINY,
              check={"walks": 2, "steps": 3, "min_b": 0.0}, **over)
    return tr


def test_mesh_walk_on_four_gloo_ranks(tmp_path):
    from tsdiff_tpu_torch.convert import params_to_jax
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork

    cfg = copy.deepcopy(common.load_json("configs", "tsdiff-condensed-h256.json"))
    H, L = 32, 2
    for d in (cfg, cfg["model"], cfg["model"]["encoder"]):
        d["hidden_dim"] = H
    cfg.update(num_convs=L, dtype="float32", members=[])
    cfg["model"]["encoder"]["num_convs"] = L
    for m in range(4):
        model = CondenseEncoderEpsNetwork(hidden_dim=H, num_convs=L,
                                          generator=torch.Generator().manual_seed(m))
        path = str(tmp_path / f"m{m}.ckpt")
        with open(path, "wb") as f:
            pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": {"model": cfg["model"]},
                         "params": params_to_jax(model.state_dict()), "ema_params": None}, f)
        cfg["members"].append(path)
    spec = dict(cell={"name": "tiny.ens4", "chips": 4}, config=cfg,
                traffic=tiny_traffic("campaign_ens4"),
                limits={"step_rel_err": 1e-4, "answers_differing": 0},
                end_to_end=END_TO_END, per_layer=[])
    line = run.run_cell(spec, 2 ** 31 + 17, 1.0, False, "cpu", time.monotonic())
    assert '"correct": true' in line, line


def test_dimenet_walk(tmp_path):
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.models import get_model

    cfg = copy.deepcopy(common.load_json("configs", "tsdiff-condensed-dimenetpp-h128.json"))
    for d in (cfg, cfg["model"], cfg["model"]["encoder"]):
        d["hidden_dim"] = 32
    cfg["model"]["encoder"].update(num_convs=2, out_emb_channels=32)
    cfg["dtype"] = "float32"
    model = get_model(Config(cfg["model"]), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.grad_dist_mlp.layers[2].weight.mul_(1e-4)
    cfg["weights"] = str(tmp_path / "w.pt")
    torch.save(model.state_dict(), cfg["weights"])
    spec = dict(cell={"name": "tiny.dimenet", "chips": 1}, config=cfg,
                traffic=tiny_traffic("campaign_dimenet"),
                limits={"step_rel_err": 1e-4, "answers_differing": 0},
                end_to_end=END_TO_END, per_layer=[])
    line = run.run_cell(spec, 2 ** 31 + 18, 1.0, False, "cpu", time.monotonic())
    assert '"correct": true' in line, line


def test_dimenet_costs_grow_with_the_work():
    w = costs.widths(common.load_json("configs", "tsdiff-condensed-dimenetpp-h128.json"))
    assert (w["H"], w["L"], w["I"], w["Bb"], w["O"], w["ns"], w["nr"]) == (128, 4, 64, 8, 256, 7, 6)
    one = costs.step_flops(23, 23 * 22, 23 * 22 * 21, w)
    assert costs.step_flops(46, 2 * 23 * 22, 2 * 23 * 22 * 21, w) == 2 * one
    assert costs.step_flops(23, 23 * 22, 0, w) < one


@pytest.mark.parametrize("name", ["mfu.dimenet", "dimenet_step_ms.dimenet", "allreduce_ms.ens4"])
def test_readers_find_nothing_without_a_trace(name):
    ctx = dict(spec={"config": common.load_json("configs",
                                                "tsdiff-condensed-dimenetpp-h128.json")},
               trace=None, window={"traced": []})
    assert run.read_metric(name, ctx) is None


def test_dimenet_control_is_the_float8_reference():
    """The DimeNet++ cell's control leaves the program at the configuration's
    bfloat16 and takes the reference with float8 products."""
    from portbench.reference import condensed
    from portbench.walk_dimenet import DimeNetCell

    spec = common.cell_spec("dimenet.campaign")
    assert spec["config"]["dtype"] == "bfloat16"
    for control, path, mm in ((False, {"quant": "none"}, torch.matmul),
                              (True, {"quant": "none", "reference_matmul": "fp8_matmul"},
                               condensed.fp8_matmul)):
        cell = DimeNetCell(spec, 1, "cpu", control=control)
        cell.weights = {}
        assert cell.path == path
        assert cell.reference().net.mm is mm


class _Walked:
    def __init__(self, rows, steps):
        self.rows, self.real, self.steps = rows, len(rows), steps


@pytest.mark.parametrize("name", ["b1_roofline.sample", "mfu.sample"])
def test_sampling_readers_count_the_members_on_the_card(name):
    """On the four-card cell rank 0 holds 2 of the 8 members: B1's roofline
    and the step's share of the peak count the work of the members its B1
    launch runs, so the same trace reads a quarter of an 8-member card's."""
    spec = common.cell_spec("tsdiff8.campaign.ens4")
    rows = [{"atom_type": [0] * n} for n in (14, 16, 12)]
    trace = {"kernels": [("packed_score_wg_kernel", 0.0, 2000.0)], "window_s": 0.01}

    def read(members):
        cell = type("MeshRank", (), {"n_members": members})()
        ctx = dict(spec=spec, cell=cell, trace=trace, window={"traced": [_Walked(rows, 625)]})
        return run.read_metric(name, ctx)

    assert name in [m["name"] for m in spec["per_layer"]]
    assert read(2) > 0
    assert read(2) == pytest.approx(read(8) / 4, rel=0.02 if name.startswith("b1") else 1e-12)


def test_new_cells_read_the_sampling_layers():
    """Both new cells report the walk's idle split and the packer's times,
    and the four-card cell B1's roofline and the step's share of the peak."""
    common_names = {"idle_share.sample", "walk_host_ms.sample", "pack_host_ms.sample",
                    "pack_ms.sample"}
    for cell, own in (("tsdiff8.campaign.ens4", {"allreduce_ms.ens4", "b1_roofline.sample",
                                                 "mfu.sample"}),
                      ("dimenet.campaign", {"dimenet_step_ms.dimenet", "mfu.dimenet"})):
        names = {m["name"] for m in common.cell_spec(cell)["per_layer"]}
        assert names == common_names | own, cell
