"""Spherical Bessel and real spherical-harmonic bases of the directional
encoders (DimeNet++, ComENet).

Port of ``tsdiff_tpu/ops/basis.py``.  The JAX package generates the closed
forms with sympy (Rayleigh's formula for the spherical Bessel functions,
the associated Legendre recurrences for the harmonics) and lambdifies them;
here the same functions are evaluated directly by the same recurrences, so
nothing needs sympy:

* ``spherical_jn``: ``j_0 .. j_{n-1}`` by the upward recurrence
  ``j_{l+1} = (2l + 1) / x * j_l - j_{l-1}`` from ``j_0 = sin x / x`` and
  ``j_1 = sin x / x^2 - cos x / x``;
* ``bessel_basis``: ``norm[l, i] * j_l(zeros[l, i] * x)`` over the first
  ``num_radial`` zeros of each order (``Jn_zeros``, ``scipy``'s ``brentq``
  as in the JAX package), normalised on the unit interval;
* ``legendre``: ``P_l^m(z)``, ``m >= 0``, by the recurrences at
  ``tsdiff_tpu/ops/basis.py:91-118``; ``real_sph_harm``: ``Y_lm`` from them,
  enumerated per l as the JAX package's Python list (m = 0..l, then -l..-1).

The Bessel recurrence loses accuracy to cancellation for high orders at
small arguments, as the closed forms do, and so does the diagonal
``sqrt(1 - cos^2)`` near the poles; both run in float64 and their results
are cast back to the input's type.  scipy is imported inside ``Jn_zeros``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def Jn_zeros(n: int, k: int) -> np.ndarray:
    """The first k positive zeros of the spherical Bessel functions of
    orders 0..n-1, (n, k) float64, each order's bracketed between the
    previous order's."""
    from scipy import special as sp
    from scipy.optimize import brentq

    zerosj = np.zeros((n, k), dtype=np.float64)
    zerosj[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    racines = np.zeros(k + n - 1, dtype=np.float64)
    for i in range(1, n):
        for j in range(k + n - 1 - i):
            racines[j] = brentq(lambda r, order: sp.spherical_jn(order, r), points[j],
                                points[j + 1], (i,))
        points = racines.copy()
        zerosj[i][:k] = racines[:k]
    return zerosj


@lru_cache(maxsize=None)
def bessel_norms(n: int, k: int) -> np.ndarray:
    """(n, k) float64: ``1 / sqrt(0.5 * j_{l+1}(zeros[l, i])^2)``, which makes
    each ``j_l(zeros[l, i] * x)`` unit-norm on [0, 1] under ``x^2 dx``."""
    from scipy import special as sp

    zeros = Jn_zeros(n, k)
    orders = np.arange(1, n + 1)[:, None]
    return 1.0 / np.sqrt(0.5 * sp.spherical_jn(orders, zeros) ** 2)


def spherical_jn(n: int, x: torch.Tensor) -> torch.Tensor:
    """``(..., n)``: ``j_0(x) .. j_{n-1}(x)`` in x's type (float64 inside)."""
    t = x.to(torch.float64)
    s, c = torch.sin(t), torch.cos(t)
    out = [s / t]
    if n > 1:
        out.append(s / t**2 - c / t)
    for l in range(1, n - 1):
        out.append((2 * l + 1) / t * out[l] - out[l - 1])
    return torch.stack(out, dim=-1).to(x.dtype)


def bessel_basis(num_spherical: int, num_radial: int, x: torch.Tensor) -> torch.Tensor:
    """``(..., num_spherical * num_radial)``: ``norm[l, i] * j_l(zeros[l, i]
    * x)``, l-major, the JAX package's ``bessel_basis`` evaluated at x."""
    zeros = torch.from_numpy(Jn_zeros(num_spherical, num_radial)).to(x.device)
    norms = torch.from_numpy(bessel_norms(num_spherical, num_radial)).to(x.device)
    t = x.to(torch.float64)[..., None, None] * zeros              # (..., l, i)
    j = spherical_jn(num_spherical, t)                           # (..., l, i, order)
    eye = torch.eye(num_spherical, dtype=torch.float64, device=x.device)
    j_l = torch.einsum("...lio,lo->...li", j, eye)               # order l of row l
    return (norms * j_l).reshape(*x.shape, -1).to(x.dtype)


def sph_harm_prefactor(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) / (4 * np.pi) * math.factorial(l - abs(m))
                     / math.factorial(l + abs(m)))


def legendre(L: int, z: torch.Tensor, zero_m_only: bool = True) -> list[list]:
    """``P[l][m]`` (m >= 0) at z: the zonal ones by Bonnet's recurrence, or
    every order with the Condon-Shortley diagonal ``P_l^l = (1 - 2l)
    sqrt(1 - z^2) P_{l-1}^{l-1}``."""
    P = [[None] * (l + 1) for l in range(L)]
    P[0][0] = torch.ones_like(z)
    if L == 1:
        return P
    if zero_m_only:
        P[1][0] = z
        for l in range(2, L):
            P[l][0] = ((2 * l - 1) * z * P[l - 1][0] - (l - 1) * P[l - 2][0]) / l
        return P
    sin = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
    for l in range(1, L):
        P[l][l] = (1 - 2 * l) * sin * P[l - 1][l - 1]
    for m in range(0, L - 1):
        P[m + 1][m] = (2 * m + 1) * z * P[m][m]
    for l in range(2, L):
        for m in range(l - 1):
            P[l][m] = ((2 * l - 1) * z * P[l - 1][m] - (l + m - 1) * P[l - 2][m]) / (l - m)
    return P


def real_sph_harm(L: int, theta: torch.Tensor, phi: torch.Tensor | None = None) -> torch.Tensor:
    """Real spherical harmonics, stacked on a last axis: ``Y_l0(theta)`` for
    l < L without ``phi`` (L of them); with ``phi`` every ``Y_lm``, per l in
    the order m = 0..l, -l..-1 (L^2 of them).  In theta's type (float64
    inside)."""
    dtype = theta.dtype
    z = torch.cos(theta.to(torch.float64))
    if phi is None:
        P = legendre(L, z, zero_m_only=True)
        return torch.stack([sph_harm_prefactor(l, 0) * P[l][0] for l in range(L)],
                           dim=-1).to(dtype)
    phi = phi.to(torch.float64)
    P = legendre(L, z, zero_m_only=False)
    out = []
    for l in range(L):
        row = [sph_harm_prefactor(l, 0) * P[l][0]]
        row += [2**0.5 * (-1) ** m * sph_harm_prefactor(l, m) * P[l][m] * torch.cos(m * phi)
                for m in range(1, l + 1)]
        row += [2**0.5 * (-1) ** m * sph_harm_prefactor(l, -m) * P[l][m] * torch.sin(m * phi)
                for m in range(l, 0, -1)]
        out += row
    return torch.stack(out, dim=-1).to(dtype)


class AngleEmb:
    """Bessel(d) x Y_l0(theta) joint basis, ``(..., num_spherical *
    num_radial)`` (reference geometry.py:335-373)."""

    def __init__(self, num_radial: int, num_spherical: int, cutoff: float = 8.0):
        assert num_radial <= 64
        self.num_radial, self.num_spherical, self.cutoff = num_radial, num_spherical, cutoff

    def __call__(self, dist: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
        n, k = self.num_spherical, self.num_radial
        rbf = bessel_basis(n, k, dist / self.cutoff).reshape(*dist.shape, n, k)
        sbf = real_sph_harm(n, angle).to(rbf.dtype)
        return (rbf * sbf[..., None]).reshape(*dist.shape, n * k)


class TorsionEmb:
    """Bessel(d) x Y_lm(theta, phi) joint basis, ``(..., num_spherical^2 *
    num_radial)`` (reference geometry.py:376-429): each order's radial
    functions repeated over its 2l + 1 harmonics."""

    def __init__(self, num_radial: int, num_spherical: int, cutoff: float = 8.0):
        assert num_radial <= 64
        self.num_radial, self.num_spherical, self.cutoff = num_radial, num_spherical, cutoff
        self.degree_in_order = np.arange(num_spherical) * 2 + 1

    def __call__(self, dist: torch.Tensor, theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        n, k = self.num_spherical, self.num_radial
        rbf = bessel_basis(n, k, dist / self.cutoff).reshape(*dist.shape, n, k)
        rbf = torch.repeat_interleave(
            rbf, torch.as_tensor(self.degree_in_order, device=rbf.device), dim=-2)
        sbf = real_sph_harm(n, theta, phi).to(rbf.dtype)
        return (rbf * sbf[..., None]).reshape(*dist.shape, n * n * k)
