"""DimeNet++'s fused triplet chain (``ops/dimenet_triplet.py``,
``csrc/dimenet_triplet.cu``).

On the CPU (tier 1): ``triplet_sum`` takes the plain version and counts it,
and never loads the kernel's library; the plain version equals the three
einsums the encoder's block ran before the kernel, bit for bit, with
autograd off and on (values and gradients).

On the card (marker ``cuda``): the kernel against the plain version on the
inputs of real batches (reactions with padded atoms, the masked angular
basis, the block inputs recorded from the condensed network with DimeNet++
at its published widths) at N = 8, 16 and 24, and at 9 (rows of cbf and
of the Bessel basis that take the kernel's 4-byte copies) and 40 (three
row tiles of the mma), in bf16 and float32; two
launches equal bit for bit; a replay inside a CUDA graph equal to the eager
call bit for bit; an N above the kernel's bound, and a call with autograd
on, taking the plain version; the whole network through the kernel against
the network through the plain version; the bf16 tolerance against versions
of the chain that leave S or lin_sbf2's output unrounded, which it has to
refuse.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_dimenet_triplet.py -s

Tolerances, as a fraction of the plain version's largest magnitude: bf16
1e-4 and float32 1e-6.  On an H100 the kernel read 4.0e-8 to 2.2e-7 in both
types at every N here: S and rw are summed over l and n in the einsums'
order, so the bf16 roundings of S and of lin_sbf2's output fall as the
einsums' do, and what is left is the sum over k taken in another order.
The same roundings with lin_sbf2 summed by another product flipped one of
them by a bf16 ulp and read 1.2e-5 at N=24; a chain that leaves the
rounding of S or of lin_sbf2's output out read 1.9e-3 to 6.0e-3
(``test_bf16_tolerance_sees_the_rounding_points``), which 1e-4 refuses.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tsdiff_tpu_torch.models.dimenetpp import _cast, _glin, _lin  # noqa: E402
from tsdiff_tpu_torch.ops import dimenet_triplet as dt  # noqa: E402

TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-4}


def parent_chain(rbf_bes, lin_sbf1, cbf, lin_sbf2, x_kj, dtype):
    """The three einsums of the encoder's block before the kernel, as they
    stood there (``ns, nr`` from the basis's shape)."""
    ns, nr = rbf_bes.shape[-2:]
    lin = lambda m, x: _lin(m, x, dtype)  # noqa: E731
    rw = torch.einsum("bjkln,lnc->bjklc", rbf_bes, lin_sbf1.reshape(ns, nr, -1))
    sbf2 = lin(lin_sbf2, torch.einsum("bijkl,bjklc->bijkc", cbf, rw))
    # T[i, j] = sum_k x_kj[j, k] * sbf2[i, j, k]
    return torch.einsum("bjkc,bijkc->bijc", x_kj, sbf2)


def random_chain_inputs(B=2, N=6, ns=7, nr=6, I=64, seed=0, device="cpu"):
    """Random block inputs with the grid's structure: cbf zero off the
    triplets of the first ``n`` atoms of each graph."""
    g = torch.Generator().manual_seed(seed)
    rbf_bes = torch.randn(B, N, N, ns, nr, generator=g)
    cbf = torch.randn(B, N, N, N, ns, generator=g)
    n = torch.tensor([N - b % 2 for b in range(B)])
    node = torch.arange(N)[None] < n[:, None]
    emask = node[:, :, None] & node[:, None, :] & ~torch.eye(N, dtype=torch.bool)
    tri = emask[:, :, :, None] & emask.transpose(1, 2)[:, None] & ~torch.eye(N, dtype=torch.bool)[
        None, :, None, :]
    cbf = cbf * tri[..., None]
    lin_sbf1 = torch.nn.Parameter(torch.randn(ns * nr, 8, generator=g) * 0.3)
    lin_sbf2 = _glin(8, I, bias=False)
    with torch.no_grad():
        lin_sbf2.weight.copy_(torch.randn(I, 8, generator=g) * 0.3)
    x_kj = torch.randn(B, N, N, I, generator=g)
    return [t.to(device) for t in (rbf_bes, cbf, x_kj)], lin_sbf1.to(device), lin_sbf2.to(device)


def w2_of(lin_sbf2, dtype):
    return lin_sbf2.weight if dtype is None else _cast(lin_sbf2.weight, dtype)


# ---------------------------------------------------------------------------
# CPU


def test_cpu_tensors_take_the_plain_version():
    (rbf_bes, cbf, x_kj), sbf1, lin2 = random_chain_inputs()
    calls, launches = dt.triplet_sum_reference.calls, dt.triplet_sum.launches
    with torch.no_grad():
        assert not dt.takes_kernel(rbf_bes, sbf1, cbf, lin2.weight, x_kj)
        t = dt.triplet_sum(rbf_bes, sbf1, cbf, lin2.weight, x_kj)
    assert dt.triplet_sum_reference.calls == calls + 1
    assert dt.triplet_sum.launches == launches
    assert t.shape == (2, 6, 6, 64) and t.dtype == torch.float32


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16],
                         ids=["none", "float32", "bfloat16"])
def test_plain_version_equals_the_parents_einsums(dtype):
    (rbf_bes, cbf, x_kj), sbf1, lin2 = random_chain_inputs(seed=1)
    with torch.no_grad():
        want = parent_chain(rbf_bes, sbf1, cbf, lin2, x_kj, dtype)
        got = dt.triplet_sum(rbf_bes, sbf1, cbf, w2_of(lin2, dtype), x_kj, dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16],
                         ids=["none", "float32", "bfloat16"])
def test_plain_version_with_autograd_equals_the_parents(dtype):
    """Values and the gradients of every input, bit for bit."""
    (rbf_bes, cbf, x_kj), sbf1, lin2 = random_chain_inputs(seed=2)
    upstream = torch.randn(2, 6, 6, 64, generator=torch.Generator().manual_seed(3))
    grads = []
    for fn in (lambda *a: parent_chain(*a[:3], lin2, a[4], dtype),
               lambda *a: dt.triplet_sum(*a[:3], w2_of(lin2, dtype), a[4], dtype)):
        leaves = [t.detach().clone().requires_grad_() for t in (rbf_bes, sbf1, cbf, x_kj)]
        lin2.zero_grad()
        out = fn(leaves[0], leaves[1], leaves[2], None, leaves[3])
        (out * upstream).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves] + [lin2.weight.grad.clone()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
def test_cpu_calls_never_load_the_library(monkeypatch, grad):
    """The kernel's limits come from its library; a CPU call decides
    without them."""
    def no_library():
        raise AssertionError("a CPU call loaded the kernel's library")

    monkeypatch.setattr(dt, "_kernel_lib", no_library)
    (rbf_bes, cbf, x_kj), sbf1, lin2 = random_chain_inputs(seed=4)
    calls = dt.triplet_sum_reference.calls
    with torch.set_grad_enabled(grad):
        for dtype in (None, torch.float32, torch.bfloat16):
            args = (rbf_bes, sbf1, cbf, w2_of(lin2, dtype), x_kj, dtype)
            assert not dt.takes_kernel(*args)
            dt.triplet_sum(*args)
    assert dt.triplet_sum_reference.calls == calls + 3


# ---------------------------------------------------------------------------
# The card

MODEL = dict(type="diffusion", network="condensenc", hidden_dim=128, feat_dim=25,
             edge_encoder="mlp", mlp_act="swish", edge_cat_act="swish", edge_order=4,
             pred_edge_order=3, edge_cutoff=10.0,
             encoder=dict(name="dimenetpp", hidden_dim=128, num_convs=2, cutoff=10.0,
                          num_spherical=7, num_radial=6, int_emb_size=64, basis_emb_size=8,
                          out_emb_channels=256, num_before_skip=1, num_after_skip=2),
             beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
             num_diffusion_timesteps=5000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def network_and_batch(N, dtype, device, seed=0, graphs=24):
    """The condensed network with DimeNet++ (2 blocks) and a batch of
    reactions of N - 7 .. N - 1 atoms (at least 4) padded to N."""
    from portbench import corpus
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.models import get_model

    traffic = {"corpus": "reactions", "shard": graphs, "sort_by_size": True,
               "sizes": {"kind": "uniform", "min": max(4, N - 7), "max": N - 1}}
    shard = corpus.make_shard(traffic, seed, 0)
    m = get_model(Config(MODEL), dtype=dtype,
                  generator=torch.Generator().manual_seed(seed)).eval().to(device)
    pb = from_numpy_graphs(shard, max_nodes=N, device=device)
    pos = torch.randn(len(shard), N, 3, generator=torch.Generator().manual_seed(seed + 1)) * 1.5
    pos = pos.to(device) * pb.node_mask[..., None]
    return m, pb, pos


def run_network(m, pb, pos):
    with torch.no_grad():
        edge_inv, _, _ = m(pb.atom_type, pb.r_feat, pb.p_feat, pos, pb.bond_mat, pb.node_mask)
    return edge_inv


def recorded_inputs(N, dtype, device, monkeypatch):
    """The arguments of every ``triplet_sum`` call of one forward of the
    network on a real batch (one per block)."""
    from tsdiff_tpu_torch.models import dimenetpp

    calls = []

    def record(*args):
        calls.append(args)
        return dt.triplet_sum_reference(*args)

    m, pb, pos = network_and_batch(N, dtype, device)
    with monkeypatch.context() as mp:
        mp.setattr(dimenetpp, "triplet_sum", record)
        run_network(m, pb, pos)
    assert len(calls) == 2 and all(c[-1] == dtype for c in calls)
    return calls


def close(got, want, dtype):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert scale > 0 and err <= TOL[dtype] * scale, (err, scale)
    return err / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("N", [8, 9, 16, 24, 40])
def test_kernel_matches_the_plain_version(cuda, monkeypatch, N, dtype):
    for args in recorded_inputs(N, dtype, cuda, monkeypatch):
        launches = dt.triplet_sum.launches
        with torch.no_grad():
            assert dt.takes_kernel(*args)
            got = dt.triplet_sum(*args)
            want = dt.triplet_sum_reference(*args)
        assert dt.triplet_sum.launches == launches + 1
        torch.cuda.synchronize()
        rel = close(got, want, dtype)
        print(f"N={N} {dtype}: max abs err {rel:.3e} of max|ref|")


@pytest.mark.cuda
def test_two_launches_equal_bit_for_bit(cuda, monkeypatch):
    for dtype in (torch.bfloat16, torch.float32):
        args = recorded_inputs(24, dtype, cuda, monkeypatch)[1]
        with torch.no_grad():
            a, b = dt.triplet_sum(*args), dt.triplet_sum(*args)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_call(cuda, monkeypatch):
    args = recorded_inputs(16, torch.bfloat16, cuda, monkeypatch)[0]
    static = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.no_grad():
        eager = dt.triplet_sum(*args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dt.triplet_sum(*static)           # the first call builds and loads outside capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        launches = dt.triplet_sum.launches
        with torch.cuda.graph(graph):
            out = dt.triplet_sum(*static)
        assert dt.triplet_sum.launches == launches + 1
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        # the replay reads the static inputs as they are at replay time
        static[4].mul_(2.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, dt.triplet_sum(*static))
    assert dt.triplet_sum.launches == launches + 2


@pytest.mark.cuda
def test_calls_the_kernel_does_not_take_go_to_the_plain_version(cuda):
    (rbf_bes, cbf, x_kj), sbf1, lin2 = random_chain_inputs(B=2, N=dt.limits()["max_n"] + 8,
                                                          device=cuda)
    for dtype in (torch.bfloat16, None):
        w2 = w2_of(lin2, dtype)
        calls, launches = dt.triplet_sum_reference.calls, dt.triplet_sum.launches
        with torch.no_grad():
            assert not dt.takes_kernel(rbf_bes, sbf1, cbf, w2, x_kj, dtype)
            dt.triplet_sum(rbf_bes, sbf1, cbf, w2, x_kj, dtype)
        assert (dt.triplet_sum_reference.calls, dt.triplet_sum.launches) == (calls + 1, launches)
    (rbf_bes, cbf, x_kj), sbf1, lin2 = random_chain_inputs(B=2, N=16, device=cuda)
    calls, launches = dt.triplet_sum_reference.calls, dt.triplet_sum.launches
    with torch.enable_grad():
        out = dt.triplet_sum(rbf_bes, sbf1, cbf, lin2.weight, x_kj)
    assert out.requires_grad
    with torch.no_grad():
        assert dt.takes_kernel(rbf_bes, sbf1, cbf, lin2.weight, x_kj)
        assert not dt.takes_kernel(rbf_bes, sbf1, cbf, lin2.weight, x_kj, torch.float16)
        assert not dt.takes_kernel(rbf_bes.double(), sbf1, cbf, lin2.weight, x_kj)
    assert (dt.triplet_sum_reference.calls, dt.triplet_sum.launches) == (calls + 1, launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
def test_network_through_the_kernel_matches_the_plain_version(cuda, monkeypatch, dtype):
    from tsdiff_tpu_torch.models import dimenetpp

    m, pb, pos = network_and_batch(24, dtype, cuda, seed=3)
    launches = dt.triplet_sum.launches
    got = run_network(m, pb, pos)
    assert dt.triplet_sum.launches == launches + 2
    with monkeypatch.context() as mp:
        mp.setattr(dimenetpp, "triplet_sum", dt.triplet_sum_reference)
        want = run_network(m, pb, pos)
    mask = pb.node_mask[:, :, None] & pb.node_mask[:, None, :]
    # the network carries a flipped rounding through its later layers
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    err = ((got - want)[..., 0] * mask).abs().max().item()
    scale = (want[..., 0] * mask).abs().max().item()
    assert err <= tol * scale, (err, scale)


def chain_rounded_at(rbf_bes, sbf1, cbf, w2, x_kj, round_s: bool, round_u: bool):
    """The bf16 chain in float32 with S and lin_sbf2's output each rounded
    to bf16 or not (both: the plain version's rounding points)."""
    ns, nr = rbf_bes.shape[-2:]
    rw = torch.einsum("bjkln,lnc->bjklc", rbf_bes, sbf1.reshape(ns, nr, -1))
    s = torch.einsum("bijkl,bjklc->bijkc", cbf, rw)
    if round_s:
        s = s.bfloat16().float()
    u = torch.nn.functional.linear(s, w2.float())
    if round_u:
        u = u.bfloat16().float()
    return torch.einsum("bjkc,bijkc->bijc", x_kj, u)


@pytest.mark.cuda
@pytest.mark.parametrize("round_s,round_u", [(True, True), (False, True), (True, False)],
                         ids=["both", "s_unrounded", "u_unrounded"])
def test_bf16_tolerance_sees_the_rounding_points(cuda, monkeypatch, round_s, round_u):
    """At N=24 in bf16 the kernel holds the tolerance and a chain with both
    roundings holds it too; one that leaves S or U unrounded does not."""
    for args in recorded_inputs(24, torch.bfloat16, cuda, monkeypatch):
        with torch.no_grad():
            want = dt.triplet_sum_reference(*args)
            close(dt.triplet_sum(*args), want, torch.bfloat16)
            variant = chain_rounded_at(*args[:5], round_s, round_u)
        rel = (variant - want).abs().max().item() / want.abs().max().item()
        print(f"S rounded {round_s}, U rounded {round_u}: {rel:.3e} of max|ref|")
        assert (rel <= TOL[torch.bfloat16]) == (round_s and round_u), rel
