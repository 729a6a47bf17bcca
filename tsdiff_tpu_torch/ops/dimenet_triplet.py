"""DimeNet++'s triplet chain of one interaction block: CUDA kernel and plain
version.

Per block, with ``rbf_bes`` (B, N, N, ns, nr) the enveloped Bessel basis of
the edge (k -> j) at [j, k], ``sbf1`` the block's ``lin_sbf1`` (ns * nr, Bb),
``cbf`` (B, N, N, N, ns) the angular basis at [i, j, k], zero off the
triplets, ``w2`` the block's ``lin_sbf2`` weight (I, Bb) and ``x_kj``
(B, N, N, I) the down-projected messages at [j, k]:

    T[b,i,j,c] = sum_k x_kj[b,j,k,c] * lin_sbf2(S)[b,i,j,k,c]
    S[b,i,j,k] = sum_l cbf[b,i,j,k,l] * rw[b,j,k,l]
    rw[b,j,k,l] = sum_n rbf_bes[b,j,k,l,n] * sbf1[l,n]

* ``triplet_sum_reference`` — the plain version: the three einsums the
  encoder's block ran, unchanged.  ``triplet_sum_reference.calls`` counts
  its calls.
* ``triplet_sum`` — the wrapper.  It launches ``csrc/dimenet_triplet.cu``
  (built at first use) on the current stream, so that a captured walk
  records it, where the call can be seen to allow it: CUDA tensors,
  autograd off, ``dtype`` bf16, float32 or None (the last two round
  nothing) with float32 inputs, I a multiple of 8, and N, ns, nr, I and
  ``lin_sbf2``'s depth (``Bb``) within ``limits()``, which the library
  reports (N: what the kernel's shared memory holds) and a CPU call never
  asks for.  Every other call takes the plain version: the CPU, DimeNet++
  training (the kernel has no backward) and larger N.
  ``triplet_sum.launches`` counts launches.

The kernel keeps the plain version's rounding points (rw and S in float32,
S and ``lin_sbf2``'s output rounded to bf16 with a bf16 network, the
product with ``x_kj`` and the sum over k in float32) and writes only T:
nothing of size B N^3 reaches device memory.  Its source's header gives
the design and the bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_LIB = "dimenet_triplet"


def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures declared."""
    from tsdiff_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.dimenet_triplet_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), *[ctypes.c_int] * 6, ctypes.c_void_p,
    ]
    lib.dimenet_triplet_launch.restype = ctypes.c_int
    lib.dimenet_triplet_error_string.argtypes = [ctypes.c_int]
    lib.dimenet_triplet_error_string.restype = ctypes.c_char_p
    lib.dimenet_triplet_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.dimenet_triplet_limits.restype = None
    return lib


@functools.cache
def limits() -> dict[str, int]:
    """The kernel's limits, as its source states them: ``max_n`` (what its
    shared memory holds), ``basis_emb`` (lin_sbf2's depth), ``max_basis_fns``
    (ns and nr each) and ``max_int`` (I).  Loads the library."""
    out = (ctypes.c_int * 4)()
    _kernel_lib().dimenet_triplet_limits(out)
    return dict(zip(("max_n", "basis_emb", "max_basis_fns", "max_int"), out))


def triplet_sum_reference(rbf_bes: torch.Tensor, sbf1: torch.Tensor, cbf: torch.Tensor,
                          w2: torch.Tensor, x_kj: torch.Tensor, dtype=None) -> torch.Tensor:
    """T (B, N, N, I) as the encoder's block computed it: ``lin_sbf2`` takes
    its input in ``dtype`` and returns float32 (None: in the input's own
    type)."""
    triplet_sum_reference.calls += 1
    ns, nr = rbf_bes.shape[-2:]
    rw = torch.einsum("bjkln,lnc->bjklc", rbf_bes, sbf1.reshape(ns, nr, -1))
    s = torch.einsum("bijkl,bjklc->bijkc", cbf, rw)
    if dtype is None:
        sbf2 = F.linear(s, w2.to(s.dtype))
    else:
        sbf2 = F.linear(s.to(dtype), w2.to(dtype)).float()
    # T[i, j] = sum_k x_kj[j, k] * sbf2[i, j, k]
    return torch.einsum("bjkc,bijkc->bijc", x_kj, sbf2)


triplet_sum_reference.calls = 0


def takes_kernel(rbf_bes, sbf1, cbf, w2, x_kj, dtype=None) -> bool:
    """Whether ``triplet_sum`` launches the kernel for these arguments."""
    if x_kj.device.type != "cuda" or torch.is_grad_enabled():
        return False
    if any(t.device != x_kj.device for t in (rbf_bes, sbf1, cbf, w2)):
        return False
    if dtype not in (None, torch.float32, torch.bfloat16):
        return False
    if any(t.dtype != torch.float32 for t in (rbf_bes, sbf1, cbf, x_kj)):
        return False
    if w2.dtype != (torch.bfloat16 if dtype == torch.bfloat16 else torch.float32):
        return False
    if rbf_bes.dim() != 5 or cbf.dim() != 5 or x_kj.dim() != 4:
        return False
    B, N, _, ns, nr = rbf_bes.shape
    I = x_kj.shape[-1]
    lim = limits()
    return (0 < N <= lim["max_n"] and 0 < ns <= lim["max_basis_fns"]
            and 0 < nr <= lim["max_basis_fns"] and I % 8 == 0 and 0 < I <= lim["max_int"]
            and B > 0
            and tuple(rbf_bes.shape) == (B, N, N, ns, nr)
            and tuple(sbf1.shape) == (ns * nr, lim["basis_emb"])
            and tuple(cbf.shape) == (B, N, N, N, ns)
            and tuple(w2.shape) == (I, lim["basis_emb"])
            and tuple(x_kj.shape) == (B, N, N, I))


def triplet_sum(rbf_bes: torch.Tensor, sbf1: torch.Tensor, cbf: torch.Tensor,
                w2: torch.Tensor, x_kj: torch.Tensor, dtype=None) -> torch.Tensor:
    """T (B, N, N, I) float32: the kernel where ``takes_kernel`` says so,
    else ``triplet_sum_reference``.  ``w2`` is ``lin_sbf2``'s weight in
    ``dtype`` where that is given."""
    if not takes_kernel(rbf_bes, sbf1, cbf, w2, x_kj, dtype):
        return triplet_sum_reference(rbf_bes, sbf1, cbf, w2, x_kj, dtype)
    B, N, _, ns, nr = rbf_bes.shape
    I = x_kj.shape[-1]
    lib = _kernel_lib()
    out = torch.empty((B, N, N, I), dtype=torch.float32, device=x_kj.device)
    tensors = [t.contiguous() for t in (rbf_bes, sbf1, cbf, w2, x_kj)] + [out]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    with torch.cuda.device(x_kj.device):
        err = lib.dimenet_triplet_launch(ptrs, B, N, ns, nr, I, int(dtype == torch.bfloat16),
                                         torch.cuda.current_stream(x_kj.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dimenet_triplet kernel launch failed ({err}: "
                           f"{lib.dimenet_triplet_error_string(err).decode()}) at B={B} N={N} "
                           f"ns={ns} nr={nr} I={I} dtype={dtype}")
    triplet_sum.launches += 1
    return out


triplet_sum.launches = 0
