"""The packed score CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
without one.  The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -s

Tolerances, as a fraction of the output's largest magnitude: float32 1e-4
(the kernel and the plain version do the same operations; only the order of
the float32 sums differs); bfloat16 3e-2 at the worst element and 3e-3 on
average (both round to bf16 at the same points, but a different float32 sum
order can flip a rounding by one bf16 ulp, 2^-8 relative, and such flips
propagate through the L blocks).
"""

import math

import pytest
import torch

from tsdiff_tpu_torch.ops import packed_score as ps

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_inputs(M, B, N, H, L, dtype, device, seed=0, V=100):
    g = torch.Generator().manual_seed(seed)
    K = N // 2

    def mat(*shape):
        return torch.randn(*shape, generator=g) / math.sqrt(shape[-1])

    def vec(*shape):
        return 0.1 * torch.randn(*shape, generator=g)

    w = dict(
        table=torch.randn(M, V, H, generator=g), dw0=torch.randn(M, H, generator=g),
        db0=vec(M, H), dw1=mat(M, H, H), db1=vec(M, H),
        c0r=mat(M, H, H), c0p=mat(M, H, H), c0b=vec(M, H), c1w=mat(M, H, H), c1b=vec(M, H),
        f1w=mat(M, L, H, H), f1b=vec(M, L, H), f2w=mat(M, L, H, H), f2b=vec(M, L, H),
        l1w=mat(M, L, H, H), l2w=mat(M, L, H, H) / N, l2b=vec(M, L, H),
        ow=mat(M, L, H, H), ob=vec(M, L, H),
        g0h=mat(M, H, H), g0e=mat(M, H, H), g0b=vec(M, H),
        g1w=mat(M, H // 2, H), g1b=vec(M, H // 2), g2w=mat(M, H // 2), g2b=vec(M, 1),
    )
    w = {k: w[k].to(device=device, dtype=dtype).contiguous() for k in ps.W_ORDER}
    z = torch.randn(M, B, N, H, generator=g).to(device=device, dtype=dtype)
    d = (0.8 + 4 * torch.rand(B, K, N, generator=g)).to(device)
    cmask = (torch.rand(B, K, N, generator=g) < 0.8).float()
    cmask[:, -1] *= 0.5
    types = [torch.randint(0, 26, (B, K, N), generator=g, dtype=torch.int32).to(device)
             for _ in range(4)]
    return w, z, d, cmask.to(device), types


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [8, 16, 24])
def test_kernel_matches_reference(cuda, dtype, N):
    M, B, H, L = 2, 3, 256, 2
    w, z, d, cmask, types = random_inputs(M, B, N, H, L, dtype, cuda, seed=N)
    launches = ps.packed_score.launches
    out = ps.packed_score(w, z, d, cmask, *types, num_blocks=L)
    torch.cuda.synchronize()
    assert ps.packed_score.launches == launches + 1
    ref = ps.packed_score_reference(w, z, d, cmask, *types, num_blocks=L)
    scale = ref.abs().max().item()
    err = (out - ref).abs()
    print(f"N={N} {dtype}: max|ref| {scale:.4g} max err {err.max().item():.3g} "
          f"mean err {err.mean().item():.3g}")
    tol_max, tol_mean = TOL[dtype]
    assert torch.isfinite(out).all()
    assert err.max().item() <= tol_max * scale
    assert err.mean().item() <= tol_mean * scale


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(cuda):
    """A CUDA tensor launches the kernel or raises; it never falls back."""
    w, z, d, cmask, types = random_inputs(1, 2, 8, 256, 1, torch.bfloat16, cuda)
    calls, launches = ps.packed_score_reference.calls, ps.packed_score.launches
    ps.packed_score(w, z, d, cmask, *types, num_blocks=1)
    assert ps.packed_score.launches == launches + 1
    assert ps.packed_score_reference.calls == calls
    # a shape the kernel does not take raises instead of falling back
    w2, z2, d2, c2, t2 = random_inputs(1, 2, 8, 32, 1, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        ps.packed_score(w2, z2, d2, c2, *t2, num_blocks=1)
    assert ps.packed_score_reference.calls == calls
