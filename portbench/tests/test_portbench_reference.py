"""The benchmark's plain reference against the port, on the CPU at small
widths: graphs and packing, the condensed encoder's per-atom score, the dual
encoder's score, and the walk's coefficients."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import corpus  # noqa: E402
from portbench.reference import graphs as G  # noqa: E402
from portbench.reference.condensed import CondensedReference, load_params, to_device  # noqa: E402
from portbench.reference.dualenc import DualReference  # noqa: E402
from portbench.reference.walk import LangevinWalk  # noqa: E402
from portbench.walk import draw_weights  # noqa: E402

REACTIONS = {"corpus": "reactions", "shard": 6, "sort_by_size": True,
             "sizes": {"kind": "normal", "mean": 14.0, "sd": 3.5, "min": 6, "max": 23}}
MOLECULES = {"corpus": "molecules", "shard": 4, "sort_by_size": False,
             "sizes": {"kind": "uniform", "min": 9, "max": 29},
             "heavy": {"max": 9, "share": 0.5, "types": [6, 7, 8], "shares": [0.7, 0.15, 0.15]}}
SCHEDULE = {"beta_schedule": "sigmoid", "beta_start": 1e-7, "beta_end": 2e-3,
            "num_diffusion_timesteps": 5000}


def port_batch(graphs, n_pad):
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs

    return from_numpy_graphs(graphs, max_nodes=n_pad)


def test_size_set_is_the_quantiles_and_the_same_for_every_seed():
    sizes = corpus.size_set(REACTIONS["sizes"], 400)
    assert sizes == sorted(sizes) and min(sizes) >= 6 and max(sizes) <= 23
    assert abs(np.mean(sizes) - 14.0) < 0.1
    a = [len(g["atom_type"]) for g in corpus.make_shard(REACTIONS, 1, 0)]
    b = [len(g["atom_type"]) for g in corpus.make_shard(REACTIONS, 2 ** 33 + 5, 3)]
    assert a == b
    assert corpus.size_set(MOLECULES["sizes"], 21) == list(range(9, 30))


@pytest.mark.parametrize("traffic", [REACTIONS, MOLECULES], ids=["reactions", "molecules"])
def test_dense_batch_equals_the_packer(traffic):
    graphs = corpus.make_shard(traffic, 7, 0)
    ref = G.dense_batch(graphs, 32, "cpu")
    port = port_batch(graphs, 32)
    for key in ("atom_type", "bond_mat", "node_mask", "pos"):
        assert torch.equal(ref[key], getattr(port, key).to(ref[key].dtype)), key
    assert torch.equal(ref["r_feat"], port.r_feat.float())


@pytest.mark.parametrize("order", [1, 3, 4])
def test_typed_edges_equal_the_port(order):
    from tsdiff_tpu_torch.core.graph_ops import extend_graph_order, extend_ts_graph

    graphs = corpus.make_shard(REACTIONS, 3, 0)
    b = G.dense_batch(graphs, 24, "cpu")
    for ours, theirs in zip(G.typed_edges(b["bond_mat"], b["node_mask"], order),
                            extend_ts_graph(b["bond_mat"], b["node_mask"], order)):
        assert torch.equal(ours, theirs)
    mols = G.dense_batch(corpus.make_shard(MOLECULES, 3, 0), 32, "cpu")
    for ours, theirs in zip(G.legacy_edges(mols["bond_mat"], mols["node_mask"], order),
                            extend_graph_order(mols["bond_mat"], mols["node_mask"], order)):
        assert torch.equal(ours, theirs)


def small_condensed(tmp_path, H=32, L=2):
    from tsdiff_tpu_torch.convert import params_to_jax
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork

    gen = torch.Generator().manual_seed(11)
    model = CondenseEncoderEpsNetwork(hidden_dim=H, num_convs=L, edge_order=4,
                                      pred_edge_order=3, generator=gen).eval()
    path = tmp_path / "m.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"params": params_to_jax(model.state_dict()), "config": {"model": {}}}, f)
    cfg = dict(hidden_dim=H, num_convs=L, edge_order=4, pred_edge_order=3, edge_cutoff=10.0,
               cutoff=10.0)
    return model, str(path), cfg


def test_condensed_score_equals_the_port_in_float32(tmp_path):
    from tsdiff_tpu_torch.core.geometry import eq_transform

    model, path, cfg = small_condensed(tmp_path)
    graphs = corpus.make_shard(REACTIONS, 5, 0)
    n_pad = 24
    ref = CondensedReference(cfg)
    batch = G.dense_batch(graphs, n_pad, "cpu")
    pos = torch.randn(len(graphs), n_pad, 3, generator=torch.Generator().manual_seed(2)) * 3
    pos = pos * batch["node_mask"][..., None]
    ours = ref.score(to_device(load_params(path)[0], "cpu"), batch, ref.static(batch), pos)
    pb = port_batch(graphs, n_pad)
    with torch.no_grad():
        edge_inv, edges, d = model(pb.atom_type, pb.r_feat, pb.p_feat, pos, pb.bond_mat,
                                   pb.node_mask)
        theirs = eq_transform(edge_inv, pos, edges.mask_global, d)
    scale = theirs.abs().max()
    assert (ours - theirs).abs().max() <= 1e-5 * scale


def test_dual_score_equals_the_port_in_float32():
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.diffusion.dual_objective import dual_eps
    from tsdiff_tpu_torch.models import get_model

    model_cfg = {"type": "diffusion", "network": "dualenc", "hidden_dim": 32, "num_convs": 2,
                 "num_convs_local": 2, "cutoff": 10.0, "mlp_act": "ReLU", "edge_order": 3,
                 "edge_encoder": "mlp", "smooth_conv": False, **SCHEDULE}
    model = get_model(Config(model_cfg)).eval()
    weights = draw_weights(model, 3, "cpu")
    model.load_state_dict(weights)
    graphs = corpus.make_shard(MOLECULES, 9, 0)
    n_pad = 32
    batch = G.dense_batch(graphs, n_pad, "cpu")
    pos = batch["pos"] + 0.3 * torch.randn(batch["pos"].shape,
                                           generator=torch.Generator().manual_seed(1))
    pos = pos * batch["node_mask"][..., None]
    ref = DualReference(model_cfg)
    ours = ref.score(weights, batch, ref.static(batch), pos, gate=1.0, w_global=0.2, clip=1000.0)
    pb = port_batch(graphs, n_pad)
    with torch.no_grad():
        theirs = dual_eps(model, pb.atom_type, pb.bond_mat, pb.node_mask, pos,
                          torch.tensor(1.0), None, 0.2, 1000.0)
    assert (ours - theirs).abs().max() <= 1e-5 * theirs.abs().max()


@pytest.mark.parametrize("respacing", [625, 5000])
def test_langevin_coefficients_equal_the_port(respacing):
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.diffusion.sampler import (SamplingSettings, build_step_coeffs,
                                                    final_frame_scale, initial_position)
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

    sched = DiffusionSchedule.from_config(Config(SCHEDULE))
    settings = SamplingSettings(n_steps=5000, timestep_respacing=respacing)
    port = build_step_coeffs(sched, settings)
    ours = LangevinWalk(SCHEDULE, 5000, respacing, 1e-7)
    assert ours.n_walk == len(port.a) and np.all(port.a == 1.0)
    np.testing.assert_allclose(ours.b, port.b, rtol=1e-6)
    np.testing.assert_allclose(ours.c, port.c, rtol=1e-6)
    assert ours.scale == final_frame_scale(sched, settings)
    x = torch.ones(1, 2, 3)
    assert torch.allclose(ours.start(x, torch.ones(1, 2, dtype=torch.bool)),
                          initial_position(sched, settings, x), rtol=1e-6)


def test_train_loss_and_adam_step_equal_the_port_in_float32(tmp_path):
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.diffusion.objective import diffusion_loss
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.train.trainer import Adam

    from portbench.reference.condensed import from_torch_names, reference_name
    from portbench.reference.train import TrainReference, adam_update

    model, _, cfg = small_condensed(tmp_path)
    model.packed_train = True
    cfg = {**cfg, **SCHEDULE}
    graphs = corpus.make_shard(REACTIONS, 4, 0)
    n_pad = 24
    gen = torch.Generator().manual_seed(3)
    t = torch.randint(0, 5000, (len(graphs),), generator=gen)
    noise = torch.randn(len(graphs), n_pad, 3, generator=gen)
    pb = port_batch(graphs, n_pad)
    loss, _ = diffusion_loss(model, DiffusionSchedule.from_config(Config(SCHEDULE)), pb, t=t,
                             noise=noise)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    opt = {"beta1": 0.95, "beta2": 0.999}
    ref = TrainReference(cfg, opt, 3000.0, 5e-4)
    p = from_torch_names(dict(model.named_parameters()))
    batch = G.dense_batch(graphs, n_pad, "cpu")
    ref_loss, ref_grads = ref.grads(p, batch, t, noise)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * ref_loss
    for name, g in zip(names, grads):
        key, transposed = reference_name(name)
        theirs = g.t() if transposed else g
        assert (ref_grads[key] - theirs).abs().max() <= 1e-4 * theirs.abs().max() + 1e-8, name
    # one optimizer step, the port's Adam against the reference's
    tx = Adam(0.95, 0.999, 3000.0)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = tx.init(params)
    updates, _, _ = tx.update(dict(zip(names, grads)), state, params)
    stepped = from_torch_names({k: params[k] - 5e-4 * updates[k] for k in names})
    ours = adam_update(p, ref_grads, ref.init_state(p), opt, 3000.0, 5e-4)
    for key in ours:
        assert torch.allclose(ours[key], stepped[key], rtol=1e-5, atol=1e-7), key


def test_train_rows_are_told_apart_by_their_bonds():
    """Two reactions of the same atom types share their chain's coordinates
    and differ in the ring-closure bond: the training check tells them apart
    by both (this corpus holds such a pair)."""
    import json

    from portbench.train import TrainCell

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "traffic",
                           "train.json")) as f:
        traffic = json.load(f)
    graphs = corpus.make_shard(traffic, 9300000002, 0)
    by_pos = {}
    for i, g in enumerate(graphs):
        by_pos.setdefault(np.asarray(g["pos"], np.float32).tobytes(), []).append(i)
    pair = next(v for v in by_pos.values() if len(v) > 1)
    keys = {TrainCell._key(np.asarray(graphs[i]["pos"]), corpus.dense_bonds(graphs[i]))
            for i in pair}
    assert len(keys) == len(pair)
