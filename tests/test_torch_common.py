"""Shared set-up of the PyTorch-port parity tests, plus checks of the pieces
every other parity test leans on: the same numpy graphs fed to both packages
give the same padded batch, and a small flax model carried across with
``params_from_jax`` gives the same node states.

Inputs are made from a seed with numpy and handed to both packages; JAX runs
on the CPU.  Tolerance: float32 at rtol=5e-4, atol=5e-5 unless a test says
otherwise (the two packages do the same float32 operations in a different
order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.models import get_model

from tsdiff_tpu_torch.config import Config as TConfig
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork

from reference_numpy import random_reaction_graph
from test_condensenc import MODEL_CFG

RTOL, ATOL = 5e-4, 5e-5


def make_graphs(rng: np.random.Generator, sizes, feat_dim: int = 8) -> list[dict]:
    return [
        dict(
            atom_type=rng.integers(1, 10, size=n),
            r_feat=(rng.random((n, feat_dim)) < 0.3).astype(np.float32),
            p_feat=(rng.random((n, feat_dim)) < 0.3).astype(np.float32),
            pos=rng.normal(scale=1.5, size=(n, 3)).astype(np.float32),
            bond_mat=random_reaction_graph(rng, n),
        )
        for n in sizes
    ]


def small_setup(seed: int = 0, sizes=(5, 8, 12, 7), n_pad: int = 12, members: int = 1):
    """A small JAX condensed model (H=32, L=2) with ``members`` parameter
    sets, the same graphs as a JAX batch and a port batch, and the port's
    member modules carrying the same weights."""
    rng = np.random.default_rng(seed)
    graphs = make_graphs(rng, sizes)
    jbatch = jax_from_numpy_graphs(graphs, max_nodes=n_pad)
    tbatch = from_numpy_graphs(graphs, max_nodes=n_pad)
    jmodel = get_model(MODEL_CFG)
    params = [
        jmodel.init(
            jax.random.key(seed + m), jbatch.atom_type, jbatch.r_feat, jbatch.p_feat,
            jbatch.pos, jbatch.bond_mat, jbatch.node_mask,
        )
        for m in range(members)
    ]
    tmodels = [torch_model(p) for p in params]
    return jmodel, params, jbatch, tmodels, tbatch, graphs


def torch_model(params, dtype=None, cfg=MODEL_CFG) -> CondenseEncoderEpsNetwork:
    model = CondenseEncoderEpsNetwork.from_config(TConfig(cfg), dtype=dtype)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model.eval()


def close(a, b, rtol=RTOL, atol=ATOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def test_from_numpy_graphs_matches_jax():
    rng = np.random.default_rng(3)
    graphs = make_graphs(rng, (4, 9, 6))
    jb = jax_from_numpy_graphs(graphs, max_nodes=10)
    tb = from_numpy_graphs(graphs, max_nodes=10)
    for name in ("atom_type", "r_feat", "p_feat", "pos", "bond_mat", "node_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_node_states_match_jax(dtype):
    """f32 at the default tolerance; bf16 (both round the embeddings and the
    feature products to bf16 once) within one bf16 ulp of the f32 values."""
    jmodel, (params,), jb, (tmodel,), tb, _ = small_setup()
    jdt = jnp.bfloat16 if dtype else None
    tdt = torch.bfloat16 if dtype else None
    jm = jmodel.clone(dtype=jdt)
    z = jm.apply(params, jb.atom_type, jb.r_feat, jb.p_feat, jb.node_mask, method="node_states")
    tm = torch_model(params, dtype=tdt)
    tz = tm.node_states(tb.atom_type, tb.r_feat, tb.p_feat, tb.node_mask)
    assert tz.dtype == (torch.bfloat16 if dtype else torch.float32)
    if dtype:
        close(tz.float(), np.asarray(z, np.float32), rtol=8e-3, atol=8e-3)
    else:
        close(tz, z)
