"""core/graph_ops.py, core/packed.py, core/geometry.py and the packed pair
info of the port against their JAX twins on the same numpy inputs.
Integer and boolean results must be equal; float32 results match at
rtol=5e-4, atol=5e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.core import geometry as jgeo
from tsdiff_tpu.core import graph_ops as jops
from tsdiff_tpu.core import packed as jpk

from tsdiff_tpu_torch.core import geometry as tgeo
from tsdiff_tpu_torch.core import graph_ops as tops
from tsdiff_tpu_torch.core import packed as tpk

from test_torch_common import close, small_setup


@pytest.fixture(scope="module")
def batches():
    _, _, jb, _, tb, _ = small_setup(seed=1, sizes=(5, 8, 12, 7, 3), n_pad=12)
    return jb, tb


def test_pair_mask_and_higher_order_adj(batches):
    jb, tb = batches
    np.testing.assert_array_equal(tops.pair_mask(tb.node_mask).numpy(),
                                  np.asarray(jops.pair_mask(jb.node_mask)))
    adj = tb.bond_mat > 0
    for order in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            tops.higher_order_adj(adj, order).numpy(),
            np.asarray(jops.higher_order_adj(jnp.asarray(adj.numpy()), order)),
        )


@pytest.mark.parametrize("order", [3, 4])
def test_extend_ts_graph(batches, order):
    jb, tb = batches
    for a, b in zip(tops.extend_ts_graph(tb.bond_mat, tb.node_mask, order),
                    jops.extend_ts_graph(jb.bond_mat, jb.node_mask, order)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_precompute_static_pairs(batches):
    jb, tb = batches
    t = tops.precompute_static_pairs(tb.bond_mat, tb.node_mask, 4, 3)
    j = jops.precompute_static_pairs(jb.bond_mat, jb.node_mask, 4, 3)
    for name in ("mask_local_in", "type_r_in", "type_p_in",
                 "mask_local_out", "type_r_out", "type_p_out"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


def test_pack_unpack_and_masks(batches):
    jb, tb = batches
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(2, 12, 12, 3)).astype(np.float32)
    packed = tpk.pack_pairs(torch.from_numpy(dense))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk.pack_pairs(jnp.asarray(dense))))
    np.testing.assert_array_equal(
        tpk.unpack_pairs(packed).numpy(), np.asarray(jpk.unpack_pairs(jnp.asarray(packed.numpy())))
    )
    np.testing.assert_array_equal(tpk.half_last_slab_mask(12).numpy(),
                                  np.asarray(jpk.half_last_slab_mask(12)))
    np.testing.assert_array_equal(tpk.packed_valid_mask(tb.node_mask).numpy(),
                                  np.asarray(jpk.packed_valid_mask(jb.node_mask)))
    valid = tpk.packed_valid_mask(tb.node_mask)
    close(tpk.packed_diff(tb.pos), jpk.packed_diff(jb.pos))
    close(tpk.packed_distance(tb.pos, valid),
          jpk.packed_distance(jb.pos, jnp.asarray(valid.numpy())))
    with pytest.raises(ValueError):
        tpk.packed_index_arrays(7)


def test_pack_static_pairs(batches):
    jb, tb = batches
    t = tpk.pack_static_pairs(tops.precompute_static_pairs(tb.bond_mat, tb.node_mask, 4, 3))
    j = jpk.pack_static_pairs(jops.precompute_static_pairs(jb.bond_mat, jb.node_mask, 4, 3))
    for name in ("mask_local_in", "type_r_in", "type_p_in",
                 "mask_local_out", "type_r_out", "type_p_out"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.type_r_in.dtype == torch.int32 and t.type_r_in.is_contiguous()


def test_build_packed_pair_info_matches_jax():
    jmodel, (params,), jb, (tmodel,), tb, _ = small_setup(seed=2)
    rng = np.random.default_rng(5)
    # spread the atoms so some pairs fall outside the 10 A cutoffs
    pos = (rng.normal(scale=6.0, size=tb.pos.shape) * tb.node_mask.numpy()[..., None])
    pos = pos.astype(np.float32)
    jpp = jmodel.precompute_packed_pairs(jb.bond_mat, jb.node_mask)
    jinfo = jmodel.build_packed_pair_info(jnp.asarray(pos), jb.node_mask, jpp)
    tpp = tmodel.precompute_packed_pairs(tb.bond_mat, tb.node_mask)
    tinfo = tmodel.build_packed_pair_info(torch.from_numpy(pos), tb.node_mask, tpp)
    for name in ("d_in", "cmask", "d_out", "m_eq"):
        close(getattr(tinfo, name), getattr(jinfo, name))
    assert 0 < float(tinfo.cmask.sum()) < float(tpk.packed_valid_mask(tb.node_mask).sum())


def test_eq_transform_packed_matches_jax():
    rng = np.random.default_rng(7)
    B, N = 3, 12
    pos = rng.normal(size=(B, N, 3)).astype(np.float32)
    score = rng.normal(size=(B, N // 2, N)).astype(np.float32)
    m_eq = (rng.random((B, N // 2, N)) < 0.7).astype(np.float32)
    m_eq[:, -1] *= 0.5
    d = (0.5 + rng.random((B, N // 2, N))).astype(np.float32)
    t = tpk.eq_transform_packed(*(torch.from_numpy(x) for x in (score, pos, m_eq, d)))
    j = jpk.eq_transform_packed(*(jnp.asarray(x) for x in (score, pos, m_eq, d)))
    close(t, j)


def test_geometry_matches_jax(batches):
    jb, tb = batches
    rng = np.random.default_rng(9)
    vec = rng.normal(scale=3.0, size=tb.pos.shape).astype(np.float32)
    close(tgeo.center_pos(torch.from_numpy(vec), tb.node_mask),
          jgeo.center_pos(jnp.asarray(vec), jb.node_mask))
    for limit in (1.0, 4.0, 1000.0):
        close(tgeo.clip_norm(torch.from_numpy(vec), limit), jgeo.clip_norm(jnp.asarray(vec), limit))
