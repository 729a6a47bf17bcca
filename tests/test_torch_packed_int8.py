"""The int8 packed score op (tsdiff_tpu_torch/ops/packed_score_int8.py)
against the JAX package.

On the CPU the wrapper takes the plain version, so these tests hold the plain
version against JAX's ``packed_score_pallas_int8`` in interpret mode, at small
width (H=32, L=2; a padded batch of 5, 8 and 11 atoms in N=12, and one of
N=8), on inputs made from a numpy seed:

* the quantized weights: int8 codes equal, scales at rtol 1e-6;
* the scores in float32: relative L2 error <= 2e-3.  Both sides do the same
  operations; float32 sums in another order can move a value across a
  rounding tie of the per-row quantization, which flips that int8 code by
  one.  Measured here: 9e-8 at N=8 and 4e-5 at N=12;
* against the port's float32 packed twin: relative L2 < 2e-2, the bound of
  the JAX test (tests/test_packed_kernel.py); measured ~3e-3.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.ops.pallas.condensed_score_packed_int8 import _SCALED as JAX_SCALED
from tsdiff_tpu.ops.pallas.condensed_score_packed_int8 import (
    extract_weights_packed_int8 as jax_extract_int8,
)

from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import packed_score_int8 as p8

from test_condensenc import MODEL_CFG
from test_torch_common import small_setup, torch_model

MATRICES = {"dw1", "c0r", "c0p", "c1w", "f1w", "f2w", "l1w", "l2w", "ow", "g0h", "g0e", "g1w"}
SETUPS = {"n12": dict(seed=0, sizes=(5, 8, 11), n_pad=12), "n8": dict(seed=1, sizes=(8, 6), n_pad=8)}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_extract_weights_packed_int8_matches_jax():
    """Same codes and scales from the same float32 parameters."""
    _, (params,), _, (tmodel,), _, _ = small_setup()
    jw = jax_extract_int8(params)
    tw = p8.extract_weights_packed_int8(tmodel.state_dict())
    assert p8.SCALED == JAX_SCALED
    assert set(tw) == set(ps.W_ORDER) | set(p8.SCALE_KEYS)
    for k in ps.W_ORDER:
        j = np.asarray(jw[k])
        if k == "table":
            j = j[: tw[k].shape[0]]          # the TPU table is padded to 128 rows
        elif k in MATRICES:
            j = np.swapaxes(j, -1, -2)       # (in, out) -> (out, in)
        assert tw[k].dtype == (torch.int8 if k in p8.QUANTIZED else torch.float32), k
        assert j.dtype == (np.int8 if k in p8.QUANTIZED else np.float32), k
        np.testing.assert_array_equal(tw[k].numpy(), j.reshape(tw[k].shape), err_msg=k)
    for k in p8.SCALE_KEYS:
        assert tw[k].dtype == torch.float32
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]).reshape(tw[k].shape),
                                   rtol=1e-6, atol=0, err_msg=k)
    # the codes use the whole range and the scales undo them
    full = ps.extract_weights_packed(tmodel.state_dict())
    for i, k in enumerate(p8.SCALED):
        assert int(tw[k].abs().max()) == 127
        np.testing.assert_allclose(tw[k].float() * tw["scales"][i], full[k],
                                   atol=float(tw["scales"][i]) * 0.5 + 1e-9)


def test_quantization_rounds_half_to_even_with_a_true_division():
    w = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -63.5]])
    q, s = p8._quant_tensor(w, per_layer=False)
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -64]]
    q, s = p8._q8_rows(w.to(torch.bfloat16))
    assert q.dtype == torch.float32 and q.tolist() == [[127, 0, 2, 2, 0, -2, -64]]
    q, s = p8._quant_tensor(torch.zeros(2, 3, 3), per_layer=True)   # all-zero layers: the floor
    np.testing.assert_allclose(s.numpy(), np.full(2, 1e-12 / 127.0, np.float32), rtol=1e-6)
    assert int(q.abs().max()) == 0


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_score_step_packed_int8_matches_jax_kernel_and_f32_twin(setup):
    jmodel, (params,), jb, _, tb, _ = small_setup(**SETUPS[setup])
    pos = jnp.asarray(jb.pos) + 0.05
    z = jmodel.apply(params, jb.atom_type, jb.r_feat, jb.p_feat, jb.node_mask,
                     method="node_states")
    jpp = jmodel.precompute_packed_pairs(jb.bond_mat, jb.node_mask)
    ref = jmodel.clone(score_quant="int8").apply(
        params, pos, jb.node_mask, z, jpp, method="score_step_packed", interpret=True)

    tq = torch_model(params, cfg={**MODEL_CFG, "score_quant": "int8"})
    tplain = torch_model(params)
    assert tq.score_quant == "int8" and tplain.score_quant is None
    tz = tq.node_states(tb.atom_type, tb.r_feat, tb.p_feat, tb.node_mask)
    tpp = tq.precompute_packed_pairs(tb.bond_mat, tb.node_mask)
    tpos = torch.from_numpy(np.array(pos))
    calls = p8.packed_score_int8_reference.calls, ps.packed_score_reference.calls
    launches = p8.packed_score_int8.launches
    out = tq.score_step_packed(tpos, tb.node_mask, tz, tpp)
    assert p8.packed_score_int8_reference.calls == calls[0] + 1   # CPU tensors: the plain version
    assert ps.packed_score_reference.calls == calls[1]            # and not the unquantized op
    assert p8.packed_score_int8.launches == launches
    assert out.shape == ref.shape and out.dtype == torch.float32
    rel = rel_l2(out.numpy(), ref)
    print(f"{setup}: int8 plain version vs JAX int8 kernel, relative L2 {rel:.3g}")
    assert rel <= 2e-3, rel
    twin = tplain.score_step_packed(tpos, tb.node_mask, tz, tpp)
    rel = rel_l2(out.numpy(), twin.numpy())
    print(f"{setup}: int8 vs the float32 packed twin, relative L2 {rel:.3g}")
    assert 1e-5 < rel < 2e-2, rel


def test_int8_weights_are_quantized_before_the_cast_to_the_working_type():
    """In bfloat16 the codes and scales are still those of the float32
    parameters; only the unquantized weights are cast."""
    _, (params,), _, _, _, _ = small_setup()
    f32 = torch_model(params, cfg={**MODEL_CFG, "score_quant": "int8"}).kernel_weights_int8()
    bf = torch_model(params, dtype=torch.bfloat16,
                     cfg={**MODEL_CFG, "score_quant": "int8"}).kernel_weights_int8()
    for k in (*p8.QUANTIZED, *p8.SCALE_KEYS):
        assert bf[k].dtype == f32[k].dtype and torch.equal(bf[k], f32[k]), k
    for k in set(ps.W_ORDER) - set(p8.QUANTIZED):
        assert bf[k].dtype == torch.bfloat16 and torch.equal(bf[k], f32[k].to(torch.bfloat16)), k


def test_unknown_score_quant_raises():
    _, (params,), _, _, tb, _ = small_setup()
    model = torch_model(params, cfg={**MODEL_CFG, "score_quant": "int4"})
    z = model.node_states(tb.atom_type, tb.r_feat, tb.p_feat, tb.node_mask)
    pp = model.precompute_packed_pairs(tb.bond_mat, tb.node_mask)
    with pytest.raises(ValueError, match="score_quant"):
        model.score_step_packed(tb.pos, tb.node_mask, z, pp)


def test_packed_score_int8_cost_splits_the_packed_cost():
    """The pair-row products count as int8 operations, the node products and
    the head's last layer as working-type flop; together they are
    packed_score_cost's flop plus the last layer."""
    M, B, N, H, L = 8, 100, 24, 256, 7
    R = (N // 2) * N
    z = torch.empty(M, B, N, H, dtype=torch.bfloat16)
    w = {"w": torch.empty(3, dtype=torch.int8)}
    cost = p8.packed_score_int8_cost(w, z, L)
    total = ps.packed_score_cost(w, z, L)
    node = 2 * M * B * L * N * 3 * H * H
    assert cost["flops"] == node + 2 * M * B * R * (H // 2)
    assert cost["int8_ops"] == total["flops"] - node
    assert 7.0e11 < cost["int8_ops"] < 7.2e11 and 5.2e10 < cost["flops"] < 5.4e10
    assert cost["bytes"] == total["bytes"]
