"""TSDiff's condensed network with the DimeNet++ encoder in the port
(``encoder.name: dimenetpp``), on the CPU at a small hidden width with the
published bottleneck widths (int_emb 64, basis_emb 8, 7 spherical and 6
radial functions) and 2 interaction blocks:

* its ``edge_inv`` and per-atom score against the benchmark's plain
  reference (``portbench/reference/dimenetpp.py``: explicit triplet lists,
  bisected Bessel zeros), within 1e-5 of max|ref| in float32: the same
  arithmetic in float32, summed in other orders (a masked dense grid
  against index lists), with the Bessel functions from another formula near
  zero; a bf16 network within 5e-2 (its linear layers' inputs are rounded
  to 8 bits of mantissa);
* steps of the ``ld`` walk through ``DenseEnsemble`` and ``WalkRunner``
  against the reference's update from the same positions (1e-4 of the score
  part: the update adds the float32 score to positions of size ~10);
* a checkpoint embedding such a config loads through ``load_members`` and
  samples through the sampling CLI and the service;
* the SchNet-only paths refuse it, naming the encoder;
* the encoder's output, and with autograd its gradients, equal to what
  the block with its own three einsums gave (the fused triplet chain's
  plain version on the CPU), bit for bit;
* its spans and the dense ensemble's and the triplet chain's counters;
* the JAX module's one ``lin_sbf`` pair, copied into each block by
  ``convert.sbf_per_block``, gives the JAX module's output with 2 blocks.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import corpus  # noqa: E402
from portbench.reference import graphs as G  # noqa: E402
from portbench.reference.dimenetpp import (  # noqa: E402
    DimeNetReference,
    DimeNetWalkReference,
    bessel_zeros,
)
from tsdiff_tpu_torch.config import Config  # noqa: E402
from tsdiff_tpu_torch.convert import params_from_jax, params_to_jax, sbf_per_block  # noqa: E402
from tsdiff_tpu_torch.core.geometry import eq_transform  # noqa: E402
from tsdiff_tpu_torch.core.graph import from_numpy_graphs  # noqa: E402
from tsdiff_tpu_torch.models import get_model  # noqa: E402
from tsdiff_tpu_torch.ops.dimenet_triplet import triplet_sum, triplet_sum_reference  # noqa: E402

SCHEDULE = dict(beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
                num_diffusion_timesteps=5000)
MODEL = dict(type="diffusion", network="condensenc", hidden_dim=32, feat_dim=25,
             edge_encoder="mlp", mlp_act="swish", edge_cat_act="swish", edge_order=4,
             pred_edge_order=3, edge_cutoff=10.0,
             encoder=dict(name="dimenetpp", hidden_dim=32, num_convs=2, cutoff=10.0,
                          num_spherical=7, num_radial=6, int_emb_size=64, basis_emb_size=8,
                          out_emb_channels=64, num_before_skip=1, num_after_skip=2),
             **SCHEDULE)
REACTIONS = {"corpus": "reactions", "shard": 5, "sort_by_size": True,
             "sizes": {"kind": "uniform", "min": 4, "max": 9}}
N_PAD = 12


def model(dtype=torch.float32, seed=0, **over):
    cfg = Config({**MODEL, **over})
    return get_model(cfg, dtype=dtype, generator=torch.Generator().manual_seed(seed)).eval()


def inputs(seed=5):
    graphs = corpus.make_shard(REACTIONS, seed, 0)
    batch = G.dense_batch(graphs, N_PAD, "cpu")
    pos = torch.randn(len(graphs), N_PAD, 3, generator=torch.Generator().manual_seed(seed)) * 1.5
    return graphs, batch, pos * batch["node_mask"][..., None]


def weights(m):
    return {k: v.detach().float() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 5e-2)],
                         ids=["float32", "bfloat16"])
def test_network_matches_the_reference(dtype, tol):
    m = model(dtype)
    graphs, batch, pos = inputs()
    ref = DimeNetReference({"model": MODEL})
    st = ref.static(batch)
    p = weights(m)
    s_ref, mask_out = ref.pair_scores(p, batch, st, pos)
    atoms_ref = ref.score(p, batch, st, pos)
    pb = from_numpy_graphs(graphs, max_nodes=N_PAD)
    with torch.no_grad():
        edge_inv, edges, d = m(pb.atom_type, pb.r_feat, pb.p_feat, pos, pb.bond_mat,
                               pb.node_mask)
        atoms = eq_transform(edge_inv, pos, edges.mask_global, d)
    assert edge_inv.dtype == torch.float32
    assert torch.equal(edges.mask_global, mask_out)
    s = torch.where(mask_out, edge_inv[..., 0], torch.zeros_like(s_ref))
    assert (s - s_ref).abs().max() <= tol * s_ref.abs().max()
    assert (atoms - atoms_ref).abs().max() <= tol * atoms_ref.abs().max()


def test_bessel_zeros_by_bisection_equal_the_ports():
    from tsdiff_tpu_torch.ops.basis import Jn_zeros

    np.testing.assert_allclose(bessel_zeros(7, 6), Jn_zeros(7, 6), rtol=1e-12)


def test_walk_steps_match_the_reference():
    """Six ``ld`` steps (5000 respaced to 6, so every step has a large
    score part) by the captured walk's runner, eagerly, each against the
    reference's update from the runner's positions before it."""
    from tsdiff_tpu_torch.diffusion.captured import WalkRunner
    from tsdiff_tpu_torch.diffusion.ensemble import DenseEnsemble, make_ensemble
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

    m = model(seed=3)
    # the head's last layer scaled down, so that the random network's scores
    # move the atoms by about their distances, as a trained one does
    with torch.no_grad():
        m.grad_dist_mlp.layers[2].weight.mul_(1e-4)
    graphs, _, _ = inputs(7)
    ensemble = make_ensemble([m])
    assert isinstance(ensemble, DenseEnsemble)
    traffic = dict(n_steps=5000, respacing=6, step_lr=1e-7, clip=1000.0)
    settings = SamplingSettings(sampling_type="ld", n_steps=5000, step_lr=1e-7, clip=1000.0,
                                timestep_respacing=6, save_traj=True)
    runner = WalkRunner(ensemble, DiffusionSchedule.from_config(Config(MODEL)), settings,
                        capture=False, step_draws=True)
    gen = torch.Generator().manual_seed(1)
    pos_init = torch.randn(len(graphs), N_PAD, 3, generator=gen)
    noise = torch.randn(runner.n_walk, len(graphs), N_PAD, 3, generator=gen)
    pos, nan = runner.run(from_numpy_graphs(graphs, max_nodes=N_PAD), pos_init, noise)
    assert not nan and np.isfinite(pos).all()
    ref = DimeNetWalkReference({"model": MODEL, **SCHEDULE}, traffic, [weights(m)], "cpu")
    gaps = ref.step_gaps(graphs, N_PAD, pos_init, noise, runner.trajectory(len(graphs)),
                         list(range(runner.n_walk)), len(graphs))
    assert gaps.shape == (6, len(graphs)) and gaps.max() <= 1e-4, gaps


def _checkpoint(path, m, cfg):
    with open(path, "wb") as f:
        pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": {"model": cfg},
                     "params": params_to_jax(m.state_dict(), m), "ema_params": None}, f)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from test_data import make_graph_dicts

    from tsdiff_tpu_torch.data.dataset import save_dataset

    d = tmp_path_factory.mktemp("dimenet_cli")
    m = model(seed=4)
    path = str(d / "m.ckpt")
    _checkpoint(path, m, MODEL)
    graphs = make_graph_dicts(np.random.default_rng(2), [5, 7, 6], feat_dim=25)
    for i, g in enumerate(graphs):
        g["smiles"] = f"g{i}"
    test_set = str(d / "test.pkl")
    save_dataset(test_set, graphs)
    return path, test_set, graphs, m


def test_checkpoint_loads_and_samples_through_the_cli(checkpoint, tmp_path):
    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.diffusion.ensemble import DenseEnsemble, load_members, make_ensemble

    path, test_set, _, m = checkpoint
    members, cfg = load_members([path], "cpu", torch.float32)
    assert cfg.encoder.name == "dimenetpp"
    assert isinstance(make_ensemble(members), DenseEnsemble)
    for k, v in m.state_dict().items():
        assert torch.equal(members[0].state_dict()[k], v), k
    base = [path, "--test_set", test_set, "--save_dir", str(tmp_path), "--n_steps", "6",
            "--batch_size", "2", "--device", "cpu", "--sort_by_size"]
    with open(sampling.main(base), "rb") as f:
        results = pickle.load(f)
    assert sorted(r["smiles"] for r in results) == ["g0", "g1", "g2"]
    for r in results:
        assert r["pos_gen"].shape == (len(r["atom_type"]), 3)
        assert np.isfinite(r["pos_gen"]).all()
    with pytest.raises(ValueError, match="dimenetpp"):
        sampling.main(base + ["--fused_score"])


def test_checkpoint_samples_through_the_service(checkpoint):
    from tsdiff_tpu_torch.serve import SamplerService

    path, _, graphs, _ = checkpoint
    svc = SamplerService([path], n_steps=4, dtype="float32", max_batch=4, device="cpu",
                         capture=False)
    try:
        results = svc.generate(graphs)
    finally:
        svc.close()
    assert [r["pos_gen"].shape for r in results] == [(len(g["atom_type"]), 3) for g in graphs]
    assert all(np.isfinite(r["pos_gen"]).all() for r in results)


@pytest.mark.parametrize("flag", [dict(fused_score=True), dict(packed_train=True),
                                  dict(score_quant="int8"), dict(use_pallas=True)],
                         ids=["fused_score", "packed_train", "score_quant", "use_pallas"])
def test_schnet_only_paths_refuse_the_encoder(flag):
    with pytest.raises(ValueError, match=f"{next(iter(flag))}.*dimenetpp"):
        model(**flag)


def test_packed_paths_refuse_the_encoder():
    from tsdiff_tpu_torch.diffusion.ensemble import PackedEnsemble

    m = model()
    for call in (m.packed_score_op, m.fused_weights, lambda: PackedEnsemble([m])):
        with pytest.raises(ValueError, match="needs the SchNet encoder; this model's encoder is "
                                             "dimenetpp"):
            call()
    with pytest.raises(NotImplementedError, match="egnn"):
        model(encoder=dict(MODEL["encoder"], name="egnn"))
    with pytest.raises(ValueError, match="hidden_dim 16 must be the network's 32"):
        model(encoder=dict(MODEL["encoder"], hidden_dim=16))


def parent_block(self, layer, e1, rbf, rbf_bes, cbf, edge_attr, dtype):
    """``DimeNetPPEncoder._block`` as it stood before the fused triplet
    chain, with its three einsums."""
    from tsdiff_tpu_torch.models.dimenetpp import _lin

    ns, nr = self.num_spherical, self.num_radial
    act = torch.nn.functional.silu
    lin = lambda m, x: _lin(m, x, dtype)  # noqa: E731
    blk = lambda name: getattr(self, f"e{layer}_{name}")  # noqa: E731
    rw = torch.einsum("bjkln,lnc->bjklc", rbf_bes, blk("lin_sbf1").reshape(ns, nr, -1))
    sbf2 = lin(blk("lin_sbf2"), torch.einsum("bijkl,bjklc->bijkc", cbf, rw))
    x1 = e1
    x_ji = act(lin(blk("lin_ji"), x1))
    x_kj = act(lin(blk("lin_kj"), x1))
    r = lin(blk("lin_rbf2"), lin(blk("lin_rbf1"), rbf))
    x_kj = x_kj * (edge_attr * r)
    x_kj = act(lin(blk("lin_down"), x_kj))
    # T[i, j] = sum_k x_kj[j, k] * sbf2[i, j, k]
    t = torch.einsum("bjkc,bijkc->bijc", x_kj, sbf2)
    e1_new = x_ji + act(lin(blk("lin_up"), t))
    for ri in range(self.num_before_skip):
        e1_new = blk(f"res_before_{ri}")(e1_new, dtype)
    e1_new = act(lin(blk("lin"), e1_new)) + x1
    for ri in range(self.num_after_skip):
        e1_new = blk(f"res_after_{ri}")(e1_new, dtype)
    return e1_new, lin(blk("lin_rbf"), rbf) * e1_new


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_encoder_gives_the_parents_output_bit_for_bit(monkeypatch, dtype, grad):
    """On the CPU the block's chain is the plain version: the network's
    output, and with autograd every parameter's gradient, equal what the
    block with its own three einsums gave."""
    from tsdiff_tpu_torch.models.dimenetpp import DimeNetPPEncoder

    graphs, _, pos = inputs()
    pb = from_numpy_graphs(graphs, max_nodes=N_PAD)
    m = model(dtype)
    results = []
    for block in (None, parent_block):
        with monkeypatch.context() as mp:
            if block is not None:
                mp.setattr(DimeNetPPEncoder, "_block", block)
            m.zero_grad()
            calls = triplet_sum_reference.calls
            with torch.set_grad_enabled(grad):
                edge_inv, _, _ = m(pb.atom_type, pb.r_feat, pb.p_feat, pos, pb.bond_mat,
                                   pb.node_mask)
                if grad:
                    edge_inv.square().sum().backward()
            assert triplet_sum_reference.calls == calls + (2 if block is None else 0)
        results.append([edge_inv.detach()] + [
            p.grad.clone() for p in m.parameters() if grad and p.grad is not None])
    assert len(results[0]) == len(results[1]) > (20 if grad else 0)
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_spans_and_counters():
    from torch.autograd import DeviceType

    from tsdiff_tpu_torch.diffusion.captured import copy_into
    from tsdiff_tpu_torch.diffusion.ensemble import DenseEnsemble

    graphs, _, pos = inputs()
    m = model()
    ens = DenseEnsemble([m])
    pb = from_numpy_graphs(graphs, max_nodes=N_PAD)
    statics = ens.prepare(pb)
    n = np.array([len(g["atom_type"]) for g in graphs])
    B = len(graphs)
    assert statics.counts.tolist() == [
        n.sum(), B * N_PAD, (n * (n - 1)).sum(), B * N_PAD ** 2,
        (n * (n - 1) * (n - 2)).sum(), B * N_PAD ** 3]
    fn = ens.step_fn(statics)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(pos)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert names.count("tsdiff.dimenet.basis") == 1
    assert names.count("tsdiff.dimenet.block") == 2
    # each block's triplet chain: the plain version on the CPU, no launch
    calls, launches = triplet_sum_reference.calls, triplet_sum.launches
    fn(pos)
    assert triplet_sum_reference.calls == calls + 2
    assert triplet_sum.launches == launches
    other = ens.prepare(from_numpy_graphs(graphs[:1] * B, max_nodes=N_PAD))
    copy_into(statics, other)
    assert statics.counts.tolist() == other.counts.tolist()


def test_jax_pair_copied_into_each_block_gives_the_jax_output():
    from tsdiff_tpu.models.dimenetpp import DimeNetPPEncoder as JDimeNet
    from tsdiff_tpu_torch.models.dimenetpp import DimeNetPPEncoder

    kw = dict(num_layers=2, hidden_channels=16, out_channels=16, int_emb_size=8,
              basis_emb_size=4, out_emb_channels=16, num_spherical=3, num_radial=4, cutoff=10.0)
    rng = np.random.default_rng(3)
    node = rng.normal(size=(2, 8, 16)).astype(np.float32)
    pos = rng.normal(scale=1.5, size=(2, 8, 3)).astype(np.float32)
    mask = np.zeros((2, 8, 8), bool)
    mask[:, :6, :6] = ~np.eye(6, dtype=bool)
    attr = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    node_mask = np.arange(8)[None].repeat(2, 0) < 6
    jm = JDimeNet(**kw)
    jp = jm.init(jax.random.key(1), node, pos, mask, attr, node_mask)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jp)
        ref = np.asarray(jm.apply(p64, *(jnp.asarray(a, jnp.float64) for a in (node, pos)),
                                  jnp.asarray(mask), jnp.asarray(attr, jnp.float64),
                                  jnp.asarray(node_mask)))
    tree = sbf_per_block(jp)
    assert {"e0_lin_sbf1", "e1_lin_sbf1", "e0_lin_sbf2", "e1_lin_sbf2"} <= set(tree["params"])
    assert "lin_sbf1" not in tree["params"]
    port = DimeNetPPEncoder(**kw).eval()
    port.load_state_dict(params_from_jax(tree))
    t = torch.from_numpy
    with torch.no_grad():
        got = port(t(node), t(pos), t(mask), t(attr), t(node_mask)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
