"""The packed score op (tsdiff_tpu_torch/ops/packed_score.py) and the packed
ensemble against the JAX package.

On the CPU the wrapper takes the plain version, so these tests hold the plain
version against JAX's fused kernel (``score_step_packed`` in interpret mode)
at small width, and against JAX's same-layout twin ``packed_score_xla`` at
full width on a trained checkpoint.  float32 throughout, at rtol=5e-4,
atol=5e-5 (same operations, different float32 summation order).  The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tsdiff_tpu.config import Config
from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.diffusion.ensemble import make_packed_ensemble_eps_fn as jax_ensemble
from tsdiff_tpu.diffusion.ensemble import stack_params as jax_stack
from tsdiff_tpu.models import get_model
from tsdiff_tpu.ops.packed_score_xla import packed_score_xla
from tsdiff_tpu.ops.pallas.condensed_score_packed import (
    extract_weights_packed as jax_extract_weights_packed,
)

from tsdiff_tpu_torch.config import Config as TConfig
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.data.synthetic import make_corpus
from tsdiff_tpu_torch.diffusion.ensemble import make_packed_ensemble_eps_fn, stack_params
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.train import load_checkpoint

from test_torch_common import close, small_setup, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "seeds", "ckpts", "seed106_best.ckpt")


def test_extract_weights_packed_matches_jax_layout():
    _, (params,), _, (tmodel,), _, _ = small_setup()
    jw = jax_extract_weights_packed(params)
    tw = ps.extract_weights_packed(tmodel.state_dict())
    assert tuple(tw) == ps.W_ORDER
    matrices = {"dw1", "c0r", "c0p", "c1w", "f1w", "f2w", "l1w", "l2w", "ow", "g0h", "g0e", "g1w"}
    for k in ps.W_ORDER:
        j = np.asarray(jw[k])
        if k == "table":
            j = j[: tw[k].shape[0]]          # the TPU table is padded to 128 rows
        elif k in matrices:
            j = np.swapaxes(j, -1, -2)       # (in, out) -> (out, in)
        np.testing.assert_array_equal(tw[k].numpy(), j.reshape(tw[k].shape))


def test_score_step_packed_matches_jax_kernel_small():
    jmodel, (params,), jb, (tmodel,), tb, _ = small_setup()
    pos = jnp.asarray(jb.pos) + 0.05
    z = jmodel.apply(params, jb.atom_type, jb.r_feat, jb.p_feat, jb.node_mask,
                     method="node_states")
    jpp = jmodel.precompute_packed_pairs(jb.bond_mat, jb.node_mask)
    ref = jmodel.apply(params, pos, jb.node_mask, z, jpp,
                       method="score_step_packed", interpret=True)

    calls, launches = ps.packed_score_reference.calls, ps.packed_score.launches
    tz = tmodel.node_states(tb.atom_type, tb.r_feat, tb.p_feat, tb.node_mask)
    tpp = tmodel.precompute_packed_pairs(tb.bond_mat, tb.node_mask)
    out = tmodel.score_step_packed(torch.from_numpy(np.array(pos)), tb.node_mask, tz, tpp)
    assert ps.packed_score_reference.calls == calls + 1   # CPU tensors: the plain version
    assert ps.packed_score.launches == launches
    assert out.shape == ref.shape and out.dtype == torch.float32
    close(out, ref)


def test_packed_score_full_width_trained_checkpoint():
    """seed106 (H=256, L=7), B=2 graphs in the N=12 bucket, vs packed_score_xla."""
    ck = load_checkpoint(CKPT)
    graphs = [g for g in make_corpus(40, seed=3) if len(g["atom_type"]) <= 12][:2]
    jb = jax_from_numpy_graphs(graphs, max_nodes=12)
    jmodel = get_model(Config(ck["config"]).model)
    params = jax.tree_util.tree_map(jnp.asarray, ck["params"])
    rng = np.random.default_rng(11)
    pos = (np.asarray(jb.pos) + rng.normal(scale=0.1, size=jb.pos.shape)).astype(np.float32)
    pos *= np.asarray(jb.node_mask)[..., None]
    jpp = jmodel.precompute_packed_pairs(jb.bond_mat, jb.node_mask)
    z = jmodel.apply(params, jb.atom_type, jb.r_feat, jb.p_feat, jb.node_mask,
                     method="node_states")
    info = jmodel.build_packed_pair_info(jnp.asarray(pos), jb.node_mask, jpp)
    ref = packed_score_xla(jax_extract_weights_packed(params), z, info.d_in, info.cmask,
                           jpp.type_r_in, jpp.type_p_in, jpp.type_r_out, jpp.type_p_out,
                           num_blocks=7)

    tmodel = torch_model(ck["params"], cfg=TConfig(ck["config"]).model)
    tb = from_numpy_graphs(graphs, max_nodes=12)
    tpp = tmodel.precompute_packed_pairs(tb.bond_mat, tb.node_mask)
    tz = tmodel.node_states(tb.atom_type, tb.r_feat, tb.p_feat, tb.node_mask)
    out = tmodel.score_step_packed(torch.from_numpy(pos), tb.node_mask, tz, tpp)
    close(out, ref)


def test_packed_ensemble_node_eq_matches_jax():
    """The slice's score: 2 members, one op call for both, member mean,
    eq_transform_packed — against JAX's packed ensemble (interpret mode)."""
    jmodel, params, jb, tmodels, tb, _ = small_setup(members=2)
    pos = np.asarray(jax.random.normal(jax.random.key(3), jb.pos.shape)) * 1.5
    pos = (pos * np.asarray(jb.node_mask)[..., None]).astype(np.float32)
    ref = jax_ensemble(jmodel, jax_stack(params), jb)(jnp.asarray(pos))
    calls = ps.packed_score_reference.calls
    node_eq_fn = make_packed_ensemble_eps_fn(tmodels, tb)
    out = node_eq_fn(torch.from_numpy(pos))
    assert ps.packed_score_reference.calls == calls + 1   # one call for both members
    close(out, ref)


def test_stack_params():
    a = {"x": torch.zeros(2, 3), "y": torch.ones(4)}
    b = {"x": torch.ones(2, 3), "y": torch.zeros(4)}
    s = stack_params([a, b])
    assert s["x"].shape == (2, 2, 3) and s["y"].shape == (2, 4)
    assert float(s["x"][1].sum()) == 6.0


def test_packed_score_cost_is_the_tpu_estimate_without_one_hot():
    """The bound's flop count: the TPU kernel's cost estimate
    (condensed_score_packed.py:222-228) minus its one-hot embedding term,
    times the members."""
    M, B, N, H, L = 8, 100, 24, 256, 7
    R = (N // 2) * N
    tpu = 2 * B * R * (H * H + 4 * 128 * H + 2 * 3 * H * H + L * (2 * H * H)
                       + 2 * H * H + H * (H // 2)) + 2 * B * L * N * 3 * H * H
    z = torch.empty(M, B, N, H, dtype=torch.bfloat16)
    cost = ps.packed_score_cost({"w": torch.empty(3, dtype=torch.bfloat16)}, z, L)
    assert cost["flops"] == M * (tpu - 2 * B * R * 4 * 128 * H)
    assert 7.5e11 < cost["flops"] < 7.7e11
    assert cost["bytes"] == 6 * B * R * 4 + z.numel() * 2 + 6 + M * B * R * 4
