"""Epipolar geometry for RANSAC and two-view BA, batched PyTorch.

Port of gtsfm_tpu/geometry/epipolar.py: E <-> F with intrinsics, Sampson and
symmetric epipolar distances, the weighted normalized
8-point solver projected to the essential manifold, pose recovery from E with
cheirality, midpoint depths, and the Faugeras-Lustman homography
decomposition. The reference wraps cv2.findEssentialMat / cv2.recoverPose
(gtsfm/frontend/verifier/ransac.py:74, gtsfm/utils/verification.py:52-95).

The JAX package replaced LAPACK calls with closed forms that batch well on a
TPU (unrolled 9x9 Cholesky inverse iteration, Newton-Schulz inverse square
root, a Cardano 3x3 SVD). The port keeps those same closed forms: they are
plain elementwise tensor code, fast enough on the card at these batch sizes,
and they keep the port's hypotheses equal to the JAX package's to f32
rounding, which is what the parity tests hold it to. ``decompose_essential``
uses ``torch.linalg.svd`` as the JAX package uses ``jnp.linalg.svd``.

Conventions: for normalized coords x1 (image i1) and x2 (image i2),
``x2^T E x1 = 0`` with ``E = [i2ti1]_x @ i2Ri1`` (i2Ei1).
"""

from __future__ import annotations

import math

import torch

from gtsfm_tpu_torch.geometry import lie


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _norm(x: torch.Tensor, dim=-1, keepdim=False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


def homogenize(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def essential_from_pose(i2Ri1: torch.Tensor, i2ti1: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for relative pose i2Ti1 (t need not be unit)."""
    return lie.hat(i2ti1) @ i2Ri1


def fundamental_from_essential(E: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    """F = K2^-T E K1^-1 (reference utils/verification.py essential->fundamental)."""
    return torch.linalg.inv(K2).transpose(-1, -2) @ E @ torch.linalg.inv(K1)


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1 (reference utils/verification.py:97)."""
    return K2.transpose(-1, -2) @ F @ K1


def sampson_distance_sq(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance (reference utils/verification.py:170).
    x1, x2: (..., N, 2); F: (..., 3, 3). Returns (..., N)."""
    p1 = homogenize(x1)
    p2 = homogenize(x2)
    Fp1 = torch.einsum("...ij,...nj->...ni", F, p1)
    Ftp2 = torch.einsum("...ji,...nj->...ni", F, p2)
    num = torch.sum(p2 * Fp1, dim=-1) ** 2
    den = Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2 + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def symmetric_epipolar_distance_sq(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared symmetric epipolar distance (reference utils/verification.py:129)."""
    p1 = homogenize(x1)
    p2 = homogenize(x2)
    Fp1 = torch.einsum("...ij,...nj->...ni", F, p1)
    Ftp2 = torch.einsum("...ji,...nj->...ni", F, p2)
    num = torch.sum(p2 * Fp1, dim=-1) ** 2
    d1 = torch.clamp(Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2, min=1e-12)
    d2 = torch.clamp(Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2, min=1e-12)
    return num * (1.0 / d1 + 1.0 / d2)


def _normalize_points(x: torch.Tensor, w: torch.Tensor):
    """Hartley normalization with weights w: similarity T with weighted
    centroid 0 and weighted RMS distance sqrt(2). Returns (x_norm, T)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mean = torch.sum(x * w[..., None], dim=-2, keepdim=True) / wsum[..., None]
    xc = x - mean
    rms = torch.sqrt(torch.clamp(
        torch.sum(torch.sum(xc * xc, dim=-1) * w, dim=-1) / wsum[..., 0], min=1e-12))
    s = math.sqrt(2.0) / rms
    xn = xc * s[..., None, None]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, z, -s * mean[..., 0, 0]], dim=-1),
            torch.stack([z, s, -s * mean[..., 0, 1]], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    return xn, T


def _chol9_unrolled(M: torch.Tensor, eps: torch.Tensor) -> list:
    """Unrolled Cholesky of (M + eps I), n = 9, as a list-of-lists of batched
    scalars."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j] + eps if i == j else M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30)) if i == j else s / L[j][j]
    return L


def _chol9_solve(L: list, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b with the unrolled factor; b (..., 9)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _smallest_eigvec_sym9(M: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of batched 9x9 PSD matrices by inverse
    iteration with a tiny shift."""
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    L = _chol9_unrolled(M, 1e-7 * tr + 1e-12)
    v = torch.ones(M.shape[:-2] + (9,), dtype=M.dtype, device=M.device)
    v[..., 0] = 1.31
    v[..., 4] = 0.47
    v[..., 8] = 0.83
    for _ in range(iters):
        v = _chol9_solve(L, v)
        v = v / torch.clamp(_norm(v, keepdim=True), min=1e-30)
    return v


def _adjugate_sym(a, b, c, d, e, f) -> torch.Tensor:
    """Adjugate (= cofactor matrix) of the symmetric 3x3 [[a b c][b d e][c e f]]."""
    return torch.stack(
        [
            torch.stack([d * f - e * e, c * e - b * f, b * e - c * d], -1),
            torch.stack([c * e - b * f, a * f - c * c, b * c - a * e], -1),
            torch.stack([b * e - c * d, b * c - a * e, a * d - b * b], -1),
        ],
        -2,
    )


def _largest_column(adj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The column of largest norm of (..., 3, 3) and its norm (..., 1)."""
    col = torch.argmax(_norm(adj, dim=-2), dim=-1)
    idx = col[..., None, None].expand(adj.shape[:-1] + (1,))
    v = torch.gather(adj, -1, idx)[..., 0]
    return v, _norm(v, keepdim=True)


def _smallest_eigvec_sym3(A: torch.Tensor, polish_iters: int = 8) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of batched symmetric PSD 3x3 matrices:
    adjugate column (exact for rank 2) + shifted power-iteration polish."""
    adj = _adjugate_sym(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    v, nv = _largest_column(adj)
    v = torch.where(nv > 1e-30, v / torch.clamp(nv, min=1e-30), _vec([0.27, 0.53, 0.80], A))
    sigma = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    S = sigma * _eye3(A) - A
    for _ in range(polish_iters):
        w = torch.einsum("...ij,...j->...i", S, v)
        v = w / torch.clamp(_norm(w, keepdim=True), min=1e-30)
    return v


def _invsqrt_spd3(G: torch.Tensor, iters: int = 14) -> torch.Tensor:
    """Batched G^{-1/2} for SPD 3x3 via scaled Newton-Schulz."""
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    c = torch.clamp(tr, min=1e-20)
    Y = G / c
    eye = _eye3(G)
    Z = eye.expand_as(Y)
    for _ in range(iters):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Z / torch.sqrt(c)


def _eigvec_for(G: torch.Tensor, lam: torch.Tensor, fallback: torch.Tensor):
    """Eigenvector of symmetric 3x3 G for eigenvalue lam via the adjugate of
    (G - lam I); ``fallback`` (3,) when the adjugate vanishes."""
    M = G - lam[..., None, None] * _eye3(G)
    adj = _adjugate_sym(M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
                        M[..., 1, 1], M[..., 1, 2], M[..., 2, 2])
    v, nv = _largest_column(adj)
    scale = torch.clamp(_norm(G, dim=(-2, -1), keepdim=True), min=1e-30)
    ok = nv > 1e-12 * scale[..., 0]
    return torch.where(ok, v / torch.clamp(nv, min=1e-30), fallback / _norm(fallback))


def _svd3x3(H: torch.Tensor):
    """Closed-form batched SVD of 3x3 matrices: (U, S, Vt), S descending
    (Cardano eigenvalues of H^T H + adjugate eigenvectors, U = H V / S with a
    signed cross-product completion; the JAX package's _svd3x3)."""
    G = H.transpose(-1, -2) @ H
    eye = _eye3(G)
    q = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = G - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.diagonal(B @ B, dim1=-2, dim2=-1).sum(-1) / 6.0, min=1e-30))
    r = torch.clamp(torch.linalg.det(B / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    fb1 = _vec([0.27, 0.53, 0.80], G)
    fb2 = _vec([0.80, -0.27, 0.53], G)
    v1 = _eigvec_for(G, lam1, fb1)
    v3 = _eigvec_for(G, lam3, fb2)
    tr3 = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None]
    for _ in range(2):
        v1n = torch.einsum("...ij,...j->...i", G, v1)
        m1 = _norm(v1n, keepdim=True)
        v1 = torch.where(m1 > 1e-20, v1n / torch.clamp(m1, min=1e-30), v1)
        v3n = tr3 * v3 - torch.einsum("...ij,...j->...i", G, v3)
        m3 = _norm(v3n, keepdim=True)
        v3 = torch.where(m3 > 1e-20, v3n / torch.clamp(m3, min=1e-30), v3)
    v3 = v3 - torch.sum(v3 * v1, dim=-1, keepdim=True) * v1
    nv3 = _norm(v3, keepdim=True)
    c1 = torch.linalg.cross(v1, fb1.expand_as(v1))
    v3 = torch.where(nv3 > 1e-12, v3 / torch.clamp(nv3, min=1e-30),
                     c1 / torch.clamp(_norm(c1, keepdim=True), min=1e-30))
    v2 = torch.linalg.cross(v3, v1)
    V = torch.stack([v1, v2, v3], dim=-1)
    S = torch.sqrt(torch.clamp(torch.stack([lam1, lam2, lam3], dim=-1), min=0.0))
    HV = H @ V
    u1 = HV[..., :, 0] / torch.clamp(S[..., 0, None], min=1e-20)
    u2 = HV[..., :, 1] / torch.clamp(S[..., 1, None], min=1e-20)
    nu1 = _norm(u1, keepdim=True)
    u1 = torch.where(nu1 > 1e-12, u1 / torch.clamp(nu1, min=1e-30),
                     (fb1 / _norm(fb1)).expand_as(u1))
    u2 = u2 - torch.sum(u2 * u1, dim=-1, keepdim=True) * u1
    nu2 = _norm(u2, keepdim=True)
    probe = torch.where(torch.abs(torch.sum(u1 * fb1, dim=-1, keepdim=True)) < 0.9,
                        fb1.expand_as(u1), fb2.expand_as(u1))
    u2_fb = torch.linalg.cross(u1, probe)
    u2_fb = u2_fb / torch.clamp(_norm(u2_fb, keepdim=True), min=1e-30)
    u2 = torch.where(nu2 > 1e-12, u2 / torch.clamp(nu2, min=1e-30), u2_fb)
    u3c = torch.linalg.cross(u1, u2)
    sgn = torch.where(torch.sum(HV[..., :, 2] * u3c, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    U = torch.stack([u1, u2, u3c * sgn], dim=-1)
    return U, S, V.transpose(-1, -2)


def _rank2_project(F: torch.Tensor) -> torch.Tensor:
    """Nearest rank-2 matrix: F - (F v3) v3^T with v3 the smallest
    right-singular vector."""
    v3 = _smallest_eigvec_sym3(F.transpose(-1, -2) @ F)
    Fv3 = torch.einsum("...ij,...j->...i", F, v3)
    return F - Fv3[..., :, None] * v3[..., None, :]


def fundamental_from_eight_point(x1, x2, w=None) -> torch.Tensor:
    """Weighted, normalized 8-point algorithm, batched over leading dims.
    x1, x2: (..., N, 2), N >= 8; w: (..., N) soft weights (0 masks a row).
    Returns F (..., 3, 3), rank 2, unit Frobenius norm."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    x1n, T1 = _normalize_points(x1, w)
    x2n, T2 = _normalize_points(x2, w)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    A = A * w[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    f = _smallest_eigvec_sym9(AtA)
    F = _rank2_project(f.reshape(f.shape[:-1] + (3, 3)))
    F = T2.transpose(-1, -2) @ F @ T1
    return F / torch.clamp(_norm(F, dim=(-2, -1), keepdim=True), min=1e-12)


def essential_from_eight_point(x1, x2, w=None) -> torch.Tensor:
    """8-point on normalized coords, projected to the essential manifold
    (singular values (1, 1, 0)) without an SVD:
    E = B (B^T B + v3 v3^T)^{-1/2} with B = F (I - v3 v3^T)."""
    F = fundamental_from_eight_point(x1, x2, w)
    v3 = _smallest_eigvec_sym3(F.transpose(-1, -2) @ F)
    vv = v3[..., :, None] * v3[..., None, :]
    B = F @ (_eye3(F) - vv)
    G = B.transpose(-1, -2) @ B + vv
    return B @ _invsqrt_spd3(G)


def decompose_essential(E: torch.Tensor):
    """E -> 4 candidate (R, t) with ||t|| = 1: (R1, +t), (R1, -t), (R2, +t),
    (R2, -t). Returns (Rs (..., 4, 3, 3), ts (..., 4, 3))."""
    U, _, Vt = torch.linalg.svd(E)
    detU = torch.linalg.det(U)
    detVt = torch.linalg.det(Vt)
    one = torch.ones_like(detU)
    U = U * torch.stack([one, one, detU], dim=-1)[..., None, :]
    Vt = Vt * torch.stack([one, one, detVt], dim=-1)[..., :, None]
    W = _vec([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def _midpoint_depths(R, t, x1, x2):
    """Two-view midpoint triangulation depths (z1, z2) for pose i2Ti1 = (R, t):
    closed-form 2x2 least squares per correspondence."""
    f1 = homogenize(x1)
    f1 = f1 / _norm(f1, keepdim=True)
    f2 = homogenize(x2)
    f2 = f2 / _norm(f2, keepdim=True)
    Rf1 = torch.einsum("...ij,...nj->...ni", R, f1)
    a = torch.sum(Rf1 * Rf1, dim=-1)
    b = -torch.sum(Rf1 * f2, dim=-1)
    c = torch.sum(f2 * f2, dim=-1)
    rhs1 = -torch.sum(Rf1 * t[..., None, :], dim=-1)
    rhs2 = torch.sum(f2 * t[..., None, :], dim=-1)
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    return (c * rhs1 - b * rhs2) / det, (a * rhs2 - b * rhs1) / det


def recover_pose_from_essential(E, x1, x2, w=None):
    """Choose the (R, t) candidate with most weighted points passing
    cheirality (cv2.recoverPose, branch-free). Returns (i2Ri1, i2Ui1 (unit),
    num_in_front)."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    Rs, ts = decompose_essential(E)
    z1s, z2s = zip(*(_midpoint_depths(Rs[..., k, :, :], ts[..., k, :], x1, x2)
                     for k in range(4)))
    good = (torch.stack(z1s, dim=-2) > 0.0) & (torch.stack(z2s, dim=-2) > 0.0)
    counts = torch.sum(good * w[..., None, :], dim=-1)  # (..., 4)
    best = torch.argmax(counts, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    n = torch.gather(counts, -1, best[..., None])[..., 0]
    return R, t, n


def essentials_from_homography(H: torch.Tensor) -> torch.Tensor:
    """Two essential-matrix candidates from a calibrated homography
    (Faugeras-Lustman decomposition). H: (..., 3, 3) -> (..., 2, 3, 3).
    Degenerate inputs give near-zero, low-scoring candidates, never NaN."""
    U, S, Vt = _svd3x3(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d2 = torch.clamp(S[..., 1], min=1e-12)
    d1 = S[..., 0] / d2
    d3 = S[..., 2] / d2
    denom = torch.clamp(d1 + d3, min=1e-12)
    spread = torch.clamp(d1**2 - d3**2, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1**2 - 1.0) / spread, min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - d3**2) / spread, min=0.0))
    stheta = torch.sqrt(torch.clamp((d1**2 - 1.0) * (1.0 - d3**2), min=0.0)) / denom
    ctheta = torch.clamp((1.0 + d1 * d3) / denom, -1.0, 1.0)
    z = torch.zeros_like(ctheta)
    o = torch.ones_like(ctheta)

    def branch(sign: float):
        Rp = torch.stack(
            [
                torch.stack([ctheta, z, -sign * stheta], -1),
                torch.stack([z, o, z], -1),
                torch.stack([sign * stheta, z, ctheta], -1),
            ],
            -2,
        )
        tp = torch.stack([x1, z, -sign * x3], -1) * (d1 - d3)[..., None]
        R = s[..., None, None] * (U @ Rp @ Vt)
        t = torch.einsum("...ij,...j->...i", U, tp)
        return lie.hat(t) @ R

    return torch.stack([branch(1.0), branch(-1.0)], dim=-3)
