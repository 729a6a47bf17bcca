"""The optional encoders and their bases in the port (``tsdiff_tpu_torch``:
``ops/basis.py``, ``models/egnn.py``, ``models/dimenetpp.py``,
``models/comenet.py``, ``models.load_encoder``) against the JAX package's.

* ``Jn_zeros`` equals JAX's; ``AngleEmb``/``TorsionEmb`` are within 1e-5 of
  max|ref| of JAX's sympy-lambdified bases, evaluated in float64 (JAX's own
  float32 evaluation of the closed forms loses up to ~1e-2 of max at short
  distances to cancellation; the port's runs in float64 inside).
* Each encoder, with the JAX weights converted (``convert.params_from_jax``)
  and back (``params_to_jax`` with the module), matches JAX in its output
  and in the gradient of one weight at 1e-5 of max|ref|.  DimeNet++'s
  reference runs in float64 (its basis, above), and the JAX module's one
  ``lin_sbf1``/``lin_sbf2`` pair is copied into each of the port's blocks
  (``convert.sbf_per_block``); ComENet's phi on an edge
  that is one of its target's two reference vectors and tau on an edge whose
  ends take the same reference atom are set to their exact values, 0 and
  pi, on both sides (the port's rule, ``models/comenet.py``; JAX folds
  rounding noise there to 0 or pi).
* Padded rows stay zero, node features are rotation-invariant, dropout
  follows train/eval, and ``load_encoder`` dispatches every name.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.models.comenet import ComENetEncoder as JComENet
from tsdiff_tpu.models.dimenetpp import DimeNetPPEncoder as JDimeNet
from tsdiff_tpu.models.egnn import EGNNMixed2DEncoder as JEGNN
from tsdiff_tpu.ops import basis as jbasis
from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax, params_to_jax, sbf_per_block
from tsdiff_tpu_torch.models import load_encoder
from tsdiff_tpu_torch.models.comenet import ComENetEncoder, comenet_features
from tsdiff_tpu_torch.models.dimenetpp import DimeNetPPEncoder
from tsdiff_tpu_torch.models.egnn import EGNNMixed2DEncoder
from tsdiff_tpu_torch.ops import basis as tbasis

TOL = 1e-5


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} > {tol} x max|ref| {scale:.3e}"


def _inputs(seed, B=2, N=8, H=16, real=6):
    """The JAX tests' inputs (``tests/test_encoders_optional.py``): node
    states, positions, a random symmetric edge mask over the real atoms,
    per-edge attributes, the node mask."""
    rng = np.random.default_rng(seed)
    node = rng.normal(size=(B, N, H)).astype(np.float32)
    pos = rng.normal(scale=1.5, size=(B, N, 3)).astype(np.float32)
    m = rng.random((B, N, N)) < 0.5
    m = np.triu(m, 1)
    m = m | m.transpose(0, 2, 1)
    m[:, real:, :] = False
    m[:, :, real:] = False
    attr = rng.normal(size=(B, N, N, H)).astype(np.float32)
    node_mask = np.arange(N)[None, :].repeat(B, 0) < real
    return node, pos, m, attr, node_mask


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def _port(cls, jparams, **kw):
    """The port's module with JAX's weights, in eval mode; checks that the
    weights convert back to JAX's tree leaf for leaf."""
    model = cls(**kw).eval()
    model.load_state_dict(params_from_jax(jparams))
    back = params_to_jax(model.state_dict(), model)["params"]
    flat = jax.tree_util.tree_flatten_with_path(jparams["params"])[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))
    return model


def _grad_of(model, name, fn):
    model.zero_grad()
    out = fn()
    out.sum().backward()
    return out.detach().numpy(), dict(model.named_parameters())[name].grad.numpy()


def _jax_grad(flax_path, fn, params):
    """``(out, d sum(out) / d params[flax_path])`` of ``fn(params)``."""
    out = fn(params)
    g = jax.grad(lambda p: jnp.sum(fn(p)))(params)
    leaf = g["params"]
    for k in flax_path:
        leaf = leaf[k]
    return np.asarray(out), np.asarray(leaf)


# -- bases --------------------------------------------------------------------


def test_jn_zeros_equal_jax():
    np.testing.assert_array_equal(tbasis.Jn_zeros(7, 6), jbasis.Jn_zeros(7, 6))
    np.testing.assert_array_equal(tbasis.Jn_zeros(3, 4), jbasis.Jn_zeros(3, 4))


@pytest.mark.parametrize("nr,ns,cutoff", [(6, 7, 5.0), (3, 2, 8.0), (4, 3, 10.0)])
def test_angle_and_torsion_emb_match_jax(nr, ns, cutoff):
    """On the distances the encoders see (0.5 A up to twice the cutoff, the
    value masked pairs take) and angles over [0, pi], phi over [-pi, pi]."""
    rng = np.random.default_rng(nr * 10 + ns)
    d = np.concatenate([rng.uniform(0.5, 2 * cutoff, 500), [2 * cutoff]])
    th = rng.uniform(0.0, np.pi, d.shape)
    ph = rng.uniform(-np.pi, np.pi, d.shape)
    with jax.enable_x64(True):
        ref_a = np.asarray(jbasis.AngleEmb(nr, ns, cutoff)(jnp.asarray(d), jnp.asarray(th)))
        ref_t = np.asarray(jbasis.TorsionEmb(nr, ns, cutoff)(
            jnp.asarray(d), jnp.asarray(th), jnp.asarray(ph)))
    t = lambda x: torch.from_numpy(x.astype(np.float32))  # noqa: E731
    got_a = tbasis.AngleEmb(nr, ns, cutoff)(t(d), t(th))
    got_t = tbasis.TorsionEmb(nr, ns, cutoff)(t(d), t(th), t(ph))
    assert got_a.dtype == torch.float32
    _close(got_a.numpy(), ref_a, what="AngleEmb")
    _close(got_t.numpy(), ref_t, what="TorsionEmb")


def test_basis_needs_no_sympy():
    import subprocess
    import sys

    code = ("import sys; sys.modules['sympy'] = None\n"
            "import torch\n"
            "from tsdiff_tpu_torch.ops.basis import TorsionEmb\n"
            "x = torch.linspace(0.5, 7.0, 5)\n"
            "print(TorsionEmb(3, 2, 8.0)(x, x / 3, x / 4).shape)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert "torch.Size([5, 12])" in out.stdout


# -- EGNN ---------------------------------------------------------------------


def _egnn_pair(seed=0, H=16, convs=2):
    node, pos, m, attr, _ = _inputs(seed, H=H)
    jm = JEGNN(hidden_dim=H, num_convs=convs, dropout=0.1)
    jp = jm.init(jax.random.key(seed), node, m, attr, attr, m, pos)
    model = _port(EGNNMixed2DEncoder, jp, hidden_dim=H, num_convs=convs, dropout=0.1)
    return jm, jp, model, (node, pos, m, attr)


def test_egnn_matches_jax():
    jm, jp, model, (node, pos, m, attr) = _egnn_pair()
    attr_p = attr[..., ::-1].copy()
    ref, ref_g = _jax_grad(("gin_1", "edge_cat", "lin0", "Dense_0", "kernel"),
                           lambda p: jm.apply(p, node, m, attr, attr_p, m, pos), jp)
    t = torch.from_numpy
    got, g = _grad_of(model, "gin_1.edge_cat.lin0.weight",
                      lambda: model(t(node), t(m), t(attr), t(attr_p), t(m), t(pos)))
    _close(got, ref, what="EGNN out")
    _close(g.T, ref_g, what="EGNN grad")


def test_egnn_rotation_invariant_and_dropout_modes():
    _, _, model, (node, pos, m, attr) = _egnn_pair(seed=1)
    t = torch.from_numpy
    q = torch.from_numpy(_rotation(1))
    with torch.no_grad():
        out1 = model(t(node), t(m), t(attr), t(attr), t(m), t(pos))
        out2 = model(t(node), t(m), t(attr), t(attr), t(m), t(pos) @ q)
        torch.testing.assert_close(out1, out2, rtol=5e-4, atol=5e-5)
        model.train()
        torch.manual_seed(0)
        out3 = model(t(node), t(m), t(attr), t(attr), t(m), t(pos))
    assert not torch.equal(out1, out3)  # dropout is on in train mode


# -- DimeNet++ ------------------------------------------------------------------

DIME = dict(num_layers=1, hidden_channels=16, out_channels=16, int_emb_size=8,
            basis_emb_size=4, out_emb_channels=16, num_spherical=3, num_radial=4, cutoff=10.0)


@pytest.mark.heavy
def test_dimenetpp_matches_jax():
    node, pos, m, attr, node_mask = _inputs(2)
    jm = JDimeNet(**DIME)
    jp = jm.init(jax.random.key(0), node, pos, m, attr, node_mask)
    model = _port(DimeNetPPEncoder, sbf_per_block(jp), **DIME)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jp)
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        ref, ref_g = _jax_grad(("e0_lin_down", "kernel"), lambda p: jm.apply(
            p, f64(node), f64(pos), jnp.asarray(m), f64(attr), jnp.asarray(node_mask)), p64)
    t = torch.from_numpy
    got, g = _grad_of(model, "e0_lin_down.weight",
                      lambda: model(t(node), t(pos), t(m), t(attr), t(node_mask)))
    _close(got, ref, what="DimeNet++ out")
    _close(g.T, ref_g, what="DimeNet++ grad")
    assert np.all(got[:, 6:] == 0)  # padded rows
    with torch.no_grad():
        rot = model(t(node), t(pos) @ torch.from_numpy(_rotation(2)), t(m), t(attr),
                    t(node_mask)).numpy()
    np.testing.assert_allclose(rot, got, rtol=2e-3, atol=2e-4)


# -- ComENet --------------------------------------------------------------------

COME = dict(cutoff=8.0, num_layers=2, hidden_channels=16, out_channels=16, num_radial=2,
            num_spherical=2, num_output_layers=1)


def _exact_tau_features(monkeypatch):
    """JAX's ``comenet_features`` with the port's exact phi on the targets'
    own reference edges and exact tau on edges whose ends take the same
    reference atom."""
    import tsdiff_tpu.models.comenet as jc

    orig = jc.comenet_features

    def features(pos, emask, cutoff):
        dist, theta, phi, tau = orig(pos, emask, cutoff)
        V = pos[:, None, :, :] - pos[:, :, None, :]
        n0, n1 = jc.dense_frames(jnp.sqrt(jnp.maximum(jnp.sum(V * V, -1), 1e-18)), emask, cutoff)
        ar = jnp.arange(pos.shape[1])
        iref = jnp.where(n0[:, :, None] == ar[None, None, :], n1[:, :, None], n0[:, :, None])
        jref = jnp.where(n0[:, None, :] == ar[None, :, None], n1[:, None, :], n0[:, None, :])
        own = (n0[:, :, None] == ar[None, None, :]) | (n1[:, :, None] == ar[None, None, :])
        return dist, theta, jnp.where(own, 0.0, phi), jnp.where(iref == jref, jnp.pi, tau)

    monkeypatch.setattr(jc, "comenet_features", features)


def _comenet_inputs(seed):
    node, pos, m, attr, node_mask = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    type_r = rng.integers(0, 26, size=m.shape)
    type_p = rng.integers(0, 26, size=m.shape)
    return node, pos, m, type_r, type_p, node_mask


def test_comenet_matches_jax(monkeypatch):
    _exact_tau_features(monkeypatch)
    node, pos, m, type_r, type_p, node_mask = _comenet_inputs(3)
    jm = JComENet(**COME)
    jp = jm.init(jax.random.key(0), node, pos, m, type_r, type_p, node_mask)
    # lin_out starts at zero in both packages: give it weights so that the
    # output and the gradients upstream of it are not zero
    jp = jax.tree_util.tree_map(lambda x: x, jp)
    jp["params"]["lin_out"]["kernel"] = jnp.asarray(
        np.random.default_rng(5).normal(size=(16, 16)).astype(np.float32))
    model = _port(ComENetEncoder, jp, **COME)
    ref, ref_g = _jax_grad(("interaction_0", "conv1", "edge_lin_1", "kernel"), lambda p: jm.apply(
        p, node, pos, m, type_r, type_p, node_mask), jp)
    t = torch.from_numpy
    got, g = _grad_of(model, "interaction_0.conv1.edge_lin_1.weight", lambda: model(
        t(node), t(pos), t(m), t(type_r), t(type_p), t(node_mask)))
    _close(got, ref, what="ComENet out")
    _close(g.T, ref_g, what="ComENet grad")
    assert np.all(got[:, 6:] == 0)


def test_comenet_features_match_jax(monkeypatch):
    """(dist, theta, phi, tau) on a full edge set, equal to JAX's within
    1e-5 of pi, JAX's phi and tau given the exact values on the same edges;
    in float64 the port's equal its float32 ones on generic positions."""
    _exact_tau_features(monkeypatch)
    import tsdiff_tpu.models.comenet as jc

    _, pos, _, _, _ = _inputs(4)
    full = np.zeros((2, 8, 8), dtype=bool)
    full[:, :6, :6] = ~np.eye(6, dtype=bool)
    ref = jc.comenet_features(jnp.asarray(pos), jnp.asarray(full), 8.0)
    got = comenet_features(torch.from_numpy(pos), torch.from_numpy(full), 8.0)
    for name, a, b in zip(("dist", "theta", "phi", "tau"), got, ref):
        _close(a.numpy()[full], np.asarray(b)[full], tol=TOL, what=name)
    rng = np.random.default_rng(8)
    pos = torch.from_numpy(rng.normal(scale=2.0, size=(2, 24, 3)).astype(np.float32))
    mask = torch.ones(2, 24, 24, dtype=torch.bool) & ~torch.eye(24, dtype=torch.bool)
    f32 = comenet_features(pos, mask, 8.0)
    f64 = comenet_features(pos.double(), mask, 8.0)
    for name, a, b in zip(("dist", "theta", "phi", "tau"), f32, f64):
        _close(a.double().numpy()[mask], b.numpy()[mask], tol=TOL, what=f"{name} f32 vs f64")


# -- the registry ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["schnet", "gin", "egnn", "dimenetpp", "comenet"])
def test_load_encoder_dispatches(name):
    enc = dict(name=name, hidden_dim=16, num_convs=2, cutoff=6.0, smooth_conv=False,
               num_radial=3, num_spherical=2, num_before_skip=1, num_after_skip=1)
    gen = torch.Generator().manual_seed(0)
    model = load_encoder(Config(encoder=enc), "encoder", generator=gen)
    kinds = {"schnet": "SchNetEncoder", "gin": "GINEncoder", "egnn": "EGNNMixed2DEncoder",
             "dimenetpp": "DimeNetPPEncoder", "comenet": "ComENetEncoder"}
    assert type(model).__name__ == kinds[name]
    if name == "schnet":
        assert model.num_interactions == 2
    # the same seed draws the same weights
    again = load_encoder(Config(encoder=enc), "encoder", generator=torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k


def test_load_encoder_matches_jax_shapes():
    """Every encoder the JAX registry builds from a config has the port's
    parameter tree (names and flax shapes)."""
    from tsdiff_tpu.models import load_encoder as jload

    enc = dict(hidden_dim=16, num_convs=2, cutoff=6.0, smooth_conv=False, num_radial=3,
               num_spherical=2, num_before_skip=1, num_after_skip=1)
    node, pos, m, attr, node_mask = _inputs(6)
    type_r = np.zeros(m.shape, np.int32)
    calls = {
        "egnn": lambda mod: mod.init(jax.random.key(0), node, m, attr, attr, m, pos),
        "dimenetpp": lambda mod: mod.init(jax.random.key(0), node, pos, m, attr, node_mask),
        "comenet": lambda mod: mod.init(jax.random.key(0), node, pos, m, type_r, type_r,
                                        node_mask),
    }
    for name, init in calls.items():
        jp = init(jload(JConfig(encoder=dict(enc, name=name)), "encoder"))
        model = load_encoder(Config(encoder=dict(enc, name=name)), "encoder")
        got = params_to_jax(model.state_dict(), model)["params"]
        want = jax.tree_util.tree_map(np.shape, sbf_per_block(jp["params"]))
        assert jax.tree_util.tree_map(np.shape, got) == want, name
