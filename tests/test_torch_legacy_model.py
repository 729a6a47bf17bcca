"""The GeoDiff-legacy model pieces of the port against the JAX package.

The same numpy graphs and the same flax parameters (carried across with
``params_from_jax``) go through both packages, on the CPU in float32: the
edge encoders (mlp and gaussian), the legacy graph extension, the bond and
dihedral angles, GIN, SchNet's own atom embedding (clipped at lookup, the
table left as it is), the condensed encoder with the options the JAX model
accepts beyond the trained configuration (gaussian, smooth cutoff, relu),
and the dual encoder for mlp and gaussian, ``TS`` false and true, with and
without ``smooth_conv``, and ``type: dsm``.  The weight converter's round
trip on a dual-encoder tree and a reference GeoDiff ``.pt`` (written with
the inverse map of ``tests/test_convert.py``) close the file.  Tolerance:
1e-5 of the largest magnitude of the JAX result (``close_rel``), unless a
test says otherwise.  H = 32, 2 SchNet blocks, 2 GIN layers, N <= 12.
"""

import collections
import pickle
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.core import geometry as jgeometry
from tsdiff_tpu.core import graph_ops as jgraph_ops
from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.data import convert as jconvert
from tsdiff_tpu.models import edge as jedge
from tsdiff_tpu.models import get_model as jax_get_model
from tsdiff_tpu.models.dualenc import decompose_legacy_types as jax_decompose
from tsdiff_tpu.models.gin import GINEncoder as JaxGIN
from tsdiff_tpu.models.schnet import SchNetEncoder as JaxSchNet

from tsdiff_tpu_torch.chem import NUM_BOND_TYPES
from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax, params_to_jax
from tsdiff_tpu_torch.core import geometry, graph_ops
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.models import edge, get_model
from tsdiff_tpu_torch.models.dualenc import decompose_legacy_types
from tsdiff_tpu_torch.models.gin import GINEncoder
from tsdiff_tpu_torch.models.schnet import SchNetEncoder
from tsdiff_tpu_torch.train import load_checkpoint

from reference_numpy import random_reaction_graph
from test_condensenc import MODEL_CFG
from test_convert import dual_params_to_state_dict

H = 32
LEGACY = dict(
    network="dualenc", hidden_dim=H, num_convs=2, num_convs_local=2, cutoff=10.0,
    mlp_act="ReLU", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
    num_diffusion_timesteps=50, edge_order=3, edge_encoder="mlp", smooth_conv=False,
    type="diffusion",
)
#: the dual-encoder variants: edge encoder x TS x smooth cutoff, and dsm
VARIANTS = {
    "mlp": {},
    "mlp_ts": {"TS": True, "edge_cat_act": "relu"},
    "mlp_smooth": {"smooth_conv": True},
    "mlp_ts_smooth": {"TS": True, "smooth_conv": True, "edge_cat_act": "swish"},
    "gaussian": {"edge_encoder": "gaussian"},
    "gaussian_ts": {"edge_encoder": "gaussian", "TS": True},
    "gaussian_smooth": {"edge_encoder": "gaussian", "smooth_conv": True},
    "gaussian_ts_smooth": {"edge_encoder": "gaussian", "TS": True, "smooth_conv": True},
    "dsm": {"type": "dsm", "sigma_begin": 10.0, "sigma_end": 0.01, "num_noise_level": 10},
}


def legacy_config(variant: str = "mlp", **extra) -> dict:
    return {**LEGACY, **VARIANTS[variant], **extra}


def close_rel(a, b, tol=1e-5):
    """max |a - b| <= tol * max |b| (b the JAX result)."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
    assert err <= tol * scale, f"max err {err:.3e} > {tol:g} x {scale:.3e}"


def legacy_graphs(rng: np.random.Generator, sizes, ts: bool) -> list[dict]:
    """Small legacy graphs: zero-width features; condensed reaction codes in
    TS mode, plain bond codes 1-3 otherwise; every atom within the cutoff."""
    graphs = []
    for n in sizes:
        if ts:
            bm = random_reaction_graph(rng, n)
        else:
            bm = np.triu((rng.random((n, n)) < 0.35).astype(np.int64), 1)
            bm = bm * rng.integers(1, 4, size=(n, n))
            bm = bm + bm.T
        graphs.append(dict(
            atom_type=rng.choice([1, 6, 7, 8], size=n).astype(np.int32),
            r_feat=np.zeros((n, 0), np.float32),
            p_feat=np.zeros((n, 0), np.float32),
            pos=rng.normal(scale=1.5, size=(n, 3)).astype(np.float32),
            bond_mat=bm,
        ))
    return graphs


def batches(graphs, n_pad=12):
    return jax_from_numpy_graphs(graphs, max_nodes=n_pad), from_numpy_graphs(graphs, max_nodes=n_pad)


def t_(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def legacy_setup(variant: str = "mlp", seed: int = 0, sizes=(5, 9, 12), emb_scale: float = 3.0,
                 **extra):
    """A JAX dual encoder with its parameters (the atom embeddings scaled by
    ``emb_scale``, so that SchNet's lookup clip bites), the same graphs as a
    JAX and a port batch, and the port's model with the same weights."""
    cfg = legacy_config(variant, **extra)
    rng = np.random.default_rng(seed)
    graphs = legacy_graphs(rng, sizes, ts=bool(cfg.get("TS", False)))
    jb, tb = batches(graphs)
    jmodel = jax_get_model(JConfig(cfg))
    t = jnp.zeros((len(sizes),), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.key(seed), jb.atom_type, jb.pos, jb.bond_mat,
                                        jb.node_mask, time_step=t))
    for enc in ("encoder_global", "encoder_local"):
        emb = params["params"][enc]["node_emb"]
        emb["embedding"] = np.asarray(emb["embedding"]) * emb_scale
    tmodel = get_model(Config(cfg))
    tmodel.load_state_dict(params_from_jax(params))
    return dict(cfg=cfg, jmodel=jmodel, params=params, jb=jb, tb=tb, tmodel=tmodel.eval(),
                graphs=graphs)


# ---- edge encoders, graph ops, geometry ----


@pytest.mark.parametrize("kind", ["mlp", "gaussian"])
def test_edge_encoders_match_jax(kind):
    rng = np.random.default_rng(1)
    d = rng.uniform(0.5, 12.0, size=(2, 6, 6, 1)).astype(np.float32)
    types_ = rng.integers(0, 30, size=(2, 6, 6))
    if kind == "mlp":
        jenc, tenc = jedge.MLPEdgeEncoder(hidden_dim=H, activation="relu"), edge.MLPEdgeEncoder(H, "relu")
    else:
        jenc, tenc = (jedge.GaussianSmearingEdgeEncoder(num_gaussians=H // 2, cutoff=10.0),
                      edge.GaussianSmearingEdgeEncoder(H // 2, 10.0))
    params = jax.device_get(jenc.init(jax.random.key(0), jnp.asarray(d), jnp.asarray(types_)))
    tenc.load_state_dict(params_from_jax(params))
    want = jenc.apply(params, jnp.asarray(d), jnp.asarray(types_))
    got = tenc(t_(d), t_(types_).long())
    assert tenc.out_channels == jenc.out_channels == H
    close_rel(got, want)


def test_get_edge_encoder_and_gaussian_smearing_match_jax():
    cfg = Config(hidden_dim=H, mlp_act="swish", cutoff=5.0, edge_encoder="gaussian")
    enc = edge.get_edge_encoder(cfg)
    assert isinstance(enc, edge.GaussianSmearingEdgeEncoder) and enc.out_channels == H
    assert isinstance(edge.get_edge_encoder(Config({**cfg, "edge_encoder": "mlp"})),
                      edge.MLPEdgeEncoder)
    with pytest.raises(NotImplementedError):
        edge.get_edge_encoder(Config({**cfg, "edge_encoder": "egnn"}))
    d = np.linspace(0.0, 12.0, 37, dtype=np.float32).reshape(37, 1)
    want = jedge.GaussianSmearing(0.0, 10.0, 16).apply({}, jnp.asarray(d))
    close_rel(edge.GaussianSmearing(0.0, 10.0, 16)(t_(d)), want)


def test_legacy_graph_ops_match_jax():
    rng = np.random.default_rng(2)
    graphs = legacy_graphs(rng, (5, 9, 12), ts=False)
    jb, tb = batches(graphs)
    for order in (1, 2, 3, 4):
        jm, jt = jgraph_ops.extend_graph_order(jb.bond_mat, jb.node_mask, order)
        m, t = graph_ops.extend_graph_order(tb.bond_mat, tb.node_mask, order)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    for eo in (True, False):
        for er in (True, False):
            jm, jt = jgraph_ops.extend_graph_order_radius(jb.bond_mat, jb.pos, jb.node_mask, 3,
                                                          2.5, eo, er)
            m, t = graph_ops.extend_graph_order_radius(tb.bond_mat, tb.pos, tb.node_mask, 3, 2.5,
                                                       eo, er)
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    rg = legacy_graphs(rng, (6, 11), ts=True)
    jb, tb = batches(rg)
    je = jgraph_ops.extend_condensed_graph_edge(jb.bond_mat, jb.pos, jb.node_mask, 4, 3.0)
    te = graph_ops.extend_condensed_graph_edge(tb.bond_mat, tb.pos, tb.node_mask, 4, 3.0)
    for name in ("mask_global", "mask_local", "type_r", "type_p"):
        np.testing.assert_array_equal(getattr(te, name).numpy(), np.asarray(getattr(je, name)))


def test_legacy_extend_graph_order_offsets():
    """The JAX package's ``test_graph_ops.py`` case: a 2-hop pair of the
    legacy extension is typed past the whole condensed vocabulary."""
    t = np.zeros((4, 4), dtype=np.int64)
    t[0, 1] = t[1, 0] = 1
    t[1, 2] = t[2, 1] = 1
    _, types_ = graph_ops.extend_graph_order(t_(t[None]), torch.ones((1, 4), dtype=torch.bool), 3)
    assert int(types_[0, 0, 2]) == NUM_BOND_TYPES**2 + 1
    assert int(types_[0, 0, 1]) == 1 and int(types_[0, 0, 3]) == 0


def test_angles_and_dihedrals_match_jax():
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(9, 3)).astype(np.float32)
    ai = np.stack([rng.permutation(9)[:3] for _ in range(7)], axis=1)
    di = np.stack([rng.permutation(9)[:4] for _ in range(7)], axis=1)
    close_rel(geometry.get_angle(t_(pos), t_(ai)), jgeometry.get_angle(jnp.asarray(pos), ai))
    close_rel(geometry.get_dihedral(t_(pos), t_(di)),
              jgeometry.get_dihedral(jnp.asarray(pos), di))


def test_decompose_legacy_types_matches_jax():
    nb = NUM_BOND_TYPES
    codes = np.array([[0, 1, 2, 1 * nb + 2, 3 * nb + 0, nb**2 + 1, nb**2 + 2, 4]])
    for ts in (False, True):
        j1, j2 = jax_decompose(jnp.asarray(codes), ts)
        t1, t2 = decompose_legacy_types(t_(codes), ts)
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
        if ts:
            np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
        else:
            assert t2 is None and j2 is None


# ---- GIN and SchNet's embedding ----


@pytest.mark.parametrize("embedding", [False, True])
def test_gin_encoder_matches_jax(embedding):
    rng = np.random.default_rng(4)
    B, N = 2, 7
    z = (rng.integers(1, 9, size=(B, N)) if embedding
         else rng.normal(size=(B, N, H)).astype(np.float32))
    ea = rng.normal(size=(B, N, N, H)).astype(np.float32)
    emask = rng.random((B, N, N)) < 0.4
    node_mask = np.ones((B, N), bool)
    node_mask[1, 5:] = False
    jgin = JaxGIN(hidden_dim=H, num_convs=2, embedding=embedding)
    params = jax.device_get(jgin.init(jax.random.key(1), jnp.asarray(z), jnp.asarray(ea),
                                      jnp.asarray(emask), jnp.asarray(node_mask)))
    gin = GINEncoder(H, num_convs=2, embedding=embedding)
    gin.load_state_dict(params_from_jax(params))
    want = jgin.apply(params, jnp.asarray(z), jnp.asarray(ea), jnp.asarray(emask),
                      jnp.asarray(node_mask))
    close_rel(gin(t_(z), t_(ea), t_(emask), t_(node_mask)), want)


def test_schnet_embedding_clips_at_lookup():
    """Rows of norm > 10 are scaled to 10 at lookup, as JAX's encoder does;
    the table itself is not changed by a forward (``nn.Embedding(max_norm)``
    would renormalise it in place)."""
    rng = np.random.default_rng(5)
    B, N = 2, 8
    z = rng.integers(1, 9, size=(B, N))
    ea = rng.normal(size=(B, N, N, H)).astype(np.float32)
    d = rng.uniform(0.5, 12.0, size=(B, N, N)).astype(np.float32)
    emask = rng.random((B, N, N)) < 0.6
    node_mask = np.ones((B, N), bool)
    node_mask[0, 6:] = False
    jenc = JaxSchNet(hidden_channels=H, num_filters=H, num_interactions=2, cutoff=10.0,
                     embedding=True, smooth=True)
    args = [jnp.asarray(x) for x in (z, ea, d, emask, node_mask)]
    params = jax.device_get(jenc.init(jax.random.key(2), *args))
    params["params"]["node_emb"]["embedding"] = np.asarray(
        params["params"]["node_emb"]["embedding"]) * 4.0
    enc = SchNetEncoder(H, H, 2, cutoff=10.0, smooth=True, embedding=True)
    enc.load_state_dict(params_from_jax(params))
    table = enc.node_emb.weight.detach().clone()
    emb = enc.embed(t_(z), torch.float32)
    assert float(table.norm(dim=-1).min()) > 10.0
    np.testing.assert_allclose(emb.detach().norm(dim=-1).numpy(), 10.0, rtol=1e-6)
    got = enc(t_(z), t_(ea), t_(d), t_(emask), node_mask=t_(node_mask))
    close_rel(got, jenc.apply(params, *args))
    assert torch.equal(enc.node_emb.weight.detach(), table)


# ---- the condensed encoder beyond the trained configuration ----


def test_condensed_gaussian_smooth_relu_matches_jax():
    """The condensed encoder with the gaussian edge encoder, the smooth
    cutoff and relu activations: built by the port as by JAX, equal forward
    (with ``use_pallas``: B3's plain twin on CPU tensors, a fractional
    cutoff mask), and refused by the kernel paths, as JAX asserts."""
    from tsdiff_tpu.core.graph import from_numpy_graphs as jfrom
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork

    from test_torch_common import make_graphs

    cfg = MODEL_CFG.to_dict()
    cfg.update(edge_encoder="gaussian", mlp_act="relu", edge_cat_act="relu")
    cfg["encoder"] = {**cfg["encoder"], "smooth_conv": True}
    graphs = make_graphs(np.random.default_rng(6), (5, 8, 12))
    jb, tb = jfrom(graphs, max_nodes=12), from_numpy_graphs(graphs, max_nodes=12)
    jmodel = jax_get_model(JConfig(cfg))
    params = jax.device_get(jmodel.init(jax.random.key(3), jb.atom_type, jb.r_feat, jb.p_feat,
                                        jb.pos, jb.bond_mat, jb.node_mask))
    want, jedges, _ = jmodel.apply(params, jb.atom_type, jb.r_feat, jb.p_feat, jb.pos,
                                   jb.bond_mat, jb.node_mask)
    m = np.asarray(jedges.mask_global)[..., None]
    for use_pallas in (False, True):
        model = CondenseEncoderEpsNetwork.from_config(Config({**cfg, "use_pallas": use_pallas}))
        model.load_state_dict(params_from_jax(params))
        got, _, _ = model(tb.atom_type, tb.r_feat, tb.p_feat, tb.pos, tb.bond_mat, tb.node_mask)
        close_rel(got.detach().numpy() * m, np.asarray(want) * m)
    with pytest.raises(ValueError, match="mlp edge encoder"):
        model.packed_score_op()
    with pytest.raises(ValueError, match="mlp edge encoder"):
        model.fused_weights()
    with pytest.raises(ValueError):
        model.score_step_packed_xla(tb.pos, tb.node_mask, None,
                                    model.precompute_packed_pairs(tb.bond_mat, tb.node_mask))


# ---- the dual encoder ----


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dual_forward_matches_jax(variant):
    s = legacy_setup(variant, seed=7)
    jb, tb = s["jb"], s["tb"]
    t = np.array([0, 4, 9], np.int32)
    eg, el, edges, d = s["jmodel"].apply(s["params"], jb.atom_type, jb.pos, jb.bond_mat,
                                         jb.node_mask, time_step=jnp.asarray(t))
    teg, tel, tedges, td = s["tmodel"](tb.atom_type, tb.pos, tb.bond_mat, tb.node_mask,
                                       time_step=t_(t).long())
    for name in ("mask_global", "mask_local", "edge_type"):
        np.testing.assert_array_equal(getattr(tedges, name).numpy(),
                                      np.asarray(getattr(edges, name)))
    close_rel(td, d)
    mg, ml = np.asarray(edges.mask_global)[..., None], np.asarray(edges.mask_local)[..., None]
    close_rel(teg.detach().numpy() * mg, np.asarray(eg) * mg)
    close_rel(tel.detach().numpy() * ml, np.asarray(el) * ml)
    if variant == "dsm":
        np.testing.assert_array_equal(s["tmodel"].sigmas, s["jmodel"].sigmas)


def test_dual_build_edges_sidechain_and_flags_match_jax():
    s = legacy_setup("mlp", seed=8)
    jb, tb = s["jb"], s["tb"]
    sc = np.random.default_rng(8).random(jb.node_mask.shape) < 0.5
    for kw in ({"is_sidechain": sc}, {"extend_order": False}, {"extend_radius": False}):
        jkw = {k: jnp.asarray(v) if k == "is_sidechain" else v for k, v in kw.items()}
        tkw = {k: t_(v) if k == "is_sidechain" else v for k, v in kw.items()}
        je = s["jmodel"].apply(s["params"], jb.bond_mat, jb.pos, jb.node_mask, method="build_edges",
                               **jkw)
        te = s["tmodel"].build_edges(tb.bond_mat, tb.pos, tb.node_mask, **tkw)
        for name in ("mask_global", "mask_local", "edge_type"):
            np.testing.assert_array_equal(getattr(te, name).numpy(), np.asarray(getattr(je, name)))


@pytest.mark.parametrize("ts", [False, True])
def test_converter_round_trip_on_a_dual_tree(ts):
    """``params_from_jax`` then ``params_to_jax`` gives the JAX tree back
    leaf for leaf; every torch name is a parameter of the port's model."""
    s = legacy_setup("mlp_ts" if ts else "mlp", seed=9)
    sd = params_from_jax(s["params"])
    assert set(sd) == set(s["tmodel"].state_dict())
    back = params_to_jax(sd)
    want = jax.tree_util.tree_leaves_with_path(s["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(s["params"])
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf, np.float32))
    names = {"/".join(str(k.key) for k in p) for p, _ in want}
    assert "params/encoder_local/convs_1/nn/layers_1/Dense_0/kernel" in names
    assert "params/encoder_global/node_emb/embedding" in names
    assert ("params/edge_cat_global/lin0/Dense_0/kernel" in names) == ts


def _write_dual_pt(path, cfg, params, ts):
    mod = types.ModuleType("easydict")
    mod.EasyDict = type("EasyDict", (dict,), {"__module__": "easydict"})
    sd = collections.OrderedDict(
        (k, torch.from_numpy(np.array(v))) for k, v in
        dual_params_to_state_dict(params, cfg["num_convs"], cfg["num_convs_local"], ts).items())
    for i in range(cfg["num_convs_local"]):
        sd[f"encoder_local.convs.{i}.eps"] = torch.zeros(1)
    sd["betas"] = torch.linspace(1e-7, 2e-3, cfg["num_diffusion_timesteps"], dtype=torch.float64)
    saved = sys.modules.get("easydict")
    sys.modules["easydict"] = mod
    try:
        cfg_ed = mod.EasyDict({"model": mod.EasyDict(cfg), "train": mod.EasyDict(seed=2021)})
        torch.save({"config": cfg_ed, "model": sd, "iteration": 77}, path)
    finally:
        if saved is None:
            del sys.modules["easydict"]
        else:
            sys.modules["easydict"] = saved


@pytest.mark.parametrize("ts", [False, True])
def test_dualenc_reference_pt_loads(tmp_path, ts):
    """A reference GeoDiff ``.pt`` of the dual encoder loads through the
    port as through the JAX package, leaf for leaf, and the loaded model
    scores as JAX's on the same weights."""
    s = legacy_setup("mlp_ts" if ts else "mlp", seed=10)
    pt = str(tmp_path / "dual.pt")
    _write_dual_pt(pt, s["cfg"], s["params"], ts)
    ck = load_checkpoint(pt)
    jck = jconvert.convert_reference_checkpoint(pt)
    assert ck["iteration"] == jck["iteration"] == 77
    want = jax.tree_util.tree_leaves_with_path(jck["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(ck["params"]))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)
    model = get_model(Config(ck["config"]["model"]))
    model.load_state_dict(params_from_jax(ck["params"]))
    jb, tb = s["jb"], s["tb"]
    eg, _, edges, _ = s["jmodel"].apply(jck["params"], jb.atom_type, jb.pos, jb.bond_mat,
                                        jb.node_mask)
    teg, *_ = model(tb.atom_type, tb.pos, tb.bond_mat, tb.node_mask)
    m = np.asarray(edges.mask_global)[..., None]
    close_rel(teg.detach().numpy() * m, np.asarray(eg) * m)
    with open(tmp_path / "dual.ckpt", "wb") as f:
        pickle.dump(ck, f)


def test_dualenc_reference_pt_with_gaussian_raises(tmp_path):
    """Only the mlp edge encoder converts, in the port as in JAX."""
    s = legacy_setup("mlp", seed=11)
    pt = str(tmp_path / "dual.pt")
    _write_dual_pt(pt, {**s["cfg"], "edge_encoder": "gaussian"}, s["params"], False)
    with pytest.raises(NotImplementedError, match="mlp edge encoder"):
        load_checkpoint(pt)
    with pytest.raises(NotImplementedError):
        jconvert.convert_reference_checkpoint(pt)
