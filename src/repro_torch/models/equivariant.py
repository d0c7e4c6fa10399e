"""E(3)/SO(3)-equivariant substrate: real spherical harmonics, Wigner-D
matrices, Clebsch-Gordan couplings (NequIP / MACE / EquiformerV2).

The counterpart of the JAX package's ``models/equivariant.py``, with the
same numerics strategy:
- real SH up to l_max via associated-Legendre recurrences (torch);
- real Wigner-D per rotation via the sampling identity
  Y_l(R p_i) = D_l(R) Y_l(p_i)  =>  D_l(R) = Y_l(R P) pinv(Y_l(P)),
  with a fixed well-conditioned point set P (pinv precomputed, numpy);
- real CG tensors as the exact nullspace of the equivariance constraint
  (D1(R)⊗D2(R)) C D3(R)^T = C stacked over a few generic rotations
  (numpy SVD at build time; cached). Couplings are SO(3)-exact; parity
  (O(3) pseudo-tensors) is not tracked.

The host constants (``_sample_points``, ``wigner_d_np``, ``cg_real``)
are copies of the reference's numpy code and give its arrays bit for
bit. The torch functions cast those constants to their input's dtype,
as the reference does.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


# --------------------------------------------------------------- real SH
def sh_basis(vec, l_max: int, xp=torch):
    """Real spherical harmonics for unit vectors.

    vec: (..., 3) -> list of arrays per l, each (..., 2l+1), index m+l.
    Convention: orthonormal on the sphere, Condon–Shortley included in
    the Legendre recurrence (consistent basis is all we need).

    ``xp=np`` computes in numpy on numpy input, as the Wigner and CG
    constants are made; the default computes on torch tensors.
    """
    if xp is np:
        def clamped_sqrt(a):
            return np.sqrt(np.maximum(a, 1e-24))

        def stack(xs):
            return np.stack(xs, axis=-1)
    else:
        def clamped_sqrt(a):
            return torch.sqrt(torch.clamp_min(a, 1e-24))

        def stack(xs):
            return torch.stack(xs, dim=-1)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r_xy = clamped_sqrt(x * x + y * y)
    cos_t = z
    sin_t = r_xy
    cos_p = x / r_xy
    sin_p = y / r_xy

    # associated Legendre P_l^m(cos_t) with sin_t supplied separately
    P = {}
    P[(0, 0)] = xp.ones_like(cos_t)
    for m in range(1, l_max + 1):
        P[(m, m)] = (-(2 * m - 1)) * sin_t * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * cos_t * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * cos_t * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    # cos(m phi), sin(m phi) by recurrence
    cos_m = [xp.ones_like(cos_p), cos_p]
    sin_m = [xp.zeros_like(sin_p), sin_p]
    for m in range(2, l_max + 1):
        cos_m.append(2 * cos_p * cos_m[-1] - cos_m[-2])
        sin_m.append(2 * cos_p * sin_m[-1] - sin_m[-2])

    out = []
    for l in range(l_max + 1):
        comps = []
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am)
                             / math.factorial(l + am))
            base = norm * P[(l, am)]
            if m == 0:
                comps.append(base)
            elif m > 0:
                comps.append(math.sqrt(2.0) * base * cos_m[am])
            else:
                comps.append(math.sqrt(2.0) * base * sin_m[am])
        out.append(stack(comps))
    return out


def _sh_numpy(vec: np.ndarray, l_max: int):
    return sh_basis(np.asarray(vec, np.float64), l_max, xp=np)


# ------------------------------------------------------------- Wigner D
@functools.lru_cache(maxsize=None)
def _sample_points(l: int) -> tuple[np.ndarray, np.ndarray]:
    """(points P, pinv(Y_l(P))) for the Wigner-D sampling identity."""
    rng = np.random.default_rng(1234 + l)
    npts = 4 * l + 6
    pts = rng.standard_normal((npts, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    y = _sh_numpy(pts, l)[l]                       # (P, 2l+1)
    return pts, np.linalg.pinv(y)


def wigner_d_np(l: int, rot: np.ndarray) -> np.ndarray:
    """Pure-numpy Wigner-D (for the CG constants)."""
    if l == 0:
        return np.ones(rot.shape[:-2] + (1, 1), np.float64)
    pts, pinv = _sample_points(l)
    rp = np.einsum("...ij,pj->...pi", rot, pts)
    y_rot = _sh_numpy(rp, l)[l]
    return np.einsum("mp,...pn->...nm", pinv, y_rot)


def _constant(array: np.ndarray, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.from_numpy(array).to(device=device, dtype=dtype)


def wigner_d(l: int, rot: torch.Tensor) -> torch.Tensor:
    """Real Wigner-D for SO(3) rotation matrices rot: (..., 3, 3)
    -> (..., 2l+1, 2l+1), acting on real-SH coefficient vectors."""
    if l == 0:
        return torch.ones(rot.shape[:-2] + (1, 1), dtype=rot.dtype,
                          device=rot.device)
    pts, pinv = _sample_points(l)
    rp = torch.einsum("...ij,pj->...pi", rot,
                      _constant(pts, rot.dtype, rot.device))
    y_rot = sh_basis(rp, l)[l]                     # (..., P, 2l+1)
    # D such that Y(R p) = Y(p) D^T  (row-vector convention) =>
    # coefficients transform c' = D c with D = (pinv @ y_rot)^T
    return torch.einsum("mp,...pn->...nm",
                        _constant(pinv, rot.dtype, rot.device), y_rot)


def rotation_to_z(vec: torch.Tensor) -> torch.Tensor:
    """Rotation R with R @ v_hat = z_hat (rows = edge frame axes)."""
    v = vec / torch.clamp_min(torch.linalg.norm(vec, dim=-1, keepdim=True),
                              1e-12)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    aux = torch.where(torch.abs(v[..., 2:3]) < 0.9, z_axis, x_axis)
    x = aux - torch.sum(aux * v, -1, keepdim=True) * v
    x = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                            1e-12)
    y = torch.linalg.cross(v, x, dim=-1)
    return torch.stack([x, y, v], dim=-2)          # rows


# ------------------------------------------------------ Clebsch-Gordan
@functools.lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real-basis CG tensor C: (2l1+1, 2l2+1, 2l3+1) with
    (D1 ⊗ D2) C = C D3 for all rotations; None if coupling is empty.
    Exact nullspace over a few generic rotations, normalized so that
    sum C^2 = 2l3+1."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rng = np.random.default_rng(7)
    mats = []
    for _ in range(3):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, xq, yq, zq = q
        rot = np.array([
            [1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - zq * w),
             2 * (xq * zq + yq * w)],
            [2 * (xq * yq + zq * w), 1 - 2 * (xq * xq + zq * zq),
             2 * (yq * zq - xq * w)],
            [2 * (xq * zq - yq * w), 2 * (yq * zq + xq * w),
             1 - 2 * (xq * xq + yq * yq)]])
        D1 = wigner_d_np(l1, rot)
        D2 = wigner_d_np(l2, rot)
        D3 = wigner_d_np(l3, rot)
        # constraint: (D1⊗D2) C - C D3 = 0, C flattened (d1 d2, d3)
        A = np.kron(D1, D2)
        # vec-form: (A ⊗ I - I ⊗ D3^T) vec(C) = 0
        mats.append(np.kron(A, np.eye(d3))
                    - np.kron(np.eye(d1 * d2), D3.T))
    big = np.concatenate(mats, axis=0)
    _, s, vt = np.linalg.svd(big)
    null = vt[s.size - np.sum(s < 1e-8):] if np.sum(s < 1e-8) else vt[-1:]
    if np.sum(s < 1e-8) == 0 and s[-1] > 1e-6:
        return None
    c = null[-1].reshape(d1, d2, d3)
    c *= math.sqrt(d3) / np.linalg.norm(c)
    return c


def cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor | None:
    """``cg_real(l1, l2, l3)`` as a tensor of ``dtype`` on ``device``
    (None for an empty coupling), made once per dtype and device."""
    return _cg_tensor(l1, l2, l3, dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _cg_tensor(l1, l2, l3, dtype, device):
    c = cg_real(l1, l2, l3)
    return None if c is None else _constant(c, dtype, device)


def couple(x1: torch.Tensor, x2: torch.Tensor, l1: int, l2: int,
           l3: int) -> torch.Tensor | None:
    """CG contraction: x1 (..., 2l1+1) ⊗ x2 (..., 2l2+1) -> (..., 2l3+1)."""
    c = cg_tensor(l1, l2, l3, x1.dtype, x1.device)
    if c is None:
        return None
    return torch.einsum("...i,...j,ijk->...k", x1, x2, c)


# ------------------------------------------------------------ radial
def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """NequIP/DimeNet Bessel radial basis with smooth cutoff envelope."""
    r = torch.clamp_min(r, 1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * r[..., None] / cutoff) / r[..., None]
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * u ** 3 + 15.0 * u ** 4 - 6.0 * u ** 5
    return basis * env[..., None]
