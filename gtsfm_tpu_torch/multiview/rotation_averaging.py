"""Global rotation averaging: chordal init + Riemannian staircase + certificate.

Port of gtsfm_tpu/multiview/rotation_averaging.py (the reference's GTSAM
ShonanAveraging3, gtsfm/averaging/rotation/shonan.py:38-199). Same recipe:

  1. connection Laplacian L (3n x 3n, dense) from the relative rotations;
  2. chordal initialization: the 3 smallest eigenvectors of L (eigh);
  3. Riemannian staircase at p in (3, 5): block-coordinate polar updates on
     St(p, 3)^n, Jacobi-damped, the polar factor by Newton-Schulz;
  4. SE-Sync certificate: min eigenvalue of L - blockdiag(Lambda) by shifted
     power iteration; lift p if it is negative;
  5. rank-3 rounding, gauge wR0 = I, handedness check.

At >= 1024 cameras a matrix-free edge-list path replaces the dense L
(anchored chordal CG init, edge-operator staircase and certificate), with the
reference's behaviour kept as it is.

Convention: the measurement for edge (i1, i2) is i2Ri1, wRi1 = wRi2 @ i2Ri1.
Everything runs in float32 on the given device.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.geometry import lie


def build_connection_laplacian(num_nodes: int, edges: np.ndarray, i2Ri1: np.ndarray) -> np.ndarray:
    """L (3n, 3n): L_ii = deg_i * I3; block (i1, i2) = -i2Ri1^T, (i2, i1) = -i2Ri1.
    Edgeless nodes get an identity diagonal block (a constant shift on the
    Stiefel manifold that moves their spurious zero modes to 1)."""
    n = num_nodes
    L = np.zeros((3 * n, 3 * n), np.float32)
    deg = np.zeros(n, np.int64)
    for e in range(edges.shape[0]):
        a, b = int(edges[e, 0]), int(edges[e, 1])
        R = np.asarray(i2Ri1[e], np.float32)
        deg[a] += 1
        deg[b] += 1
        L[3 * a:3 * a + 3, 3 * a:3 * a + 3] += np.eye(3, dtype=np.float32)
        L[3 * b:3 * b + 3, 3 * b:3 * b + 3] += np.eye(3, dtype=np.float32)
        L[3 * a:3 * a + 3, 3 * b:3 * b + 3] += -R.T
        L[3 * b:3 * b + 3, 3 * a:3 * a + 3] += -R
    for i in np.nonzero(deg == 0)[0]:
        L[3 * i:3 * i + 3, 3 * i:3 * i + 3] = np.eye(3, dtype=np.float32)
    return L


def _polar_blocks(A: torch.Tensor, n: int) -> torch.Tensor:
    """(3n, p) -> nearest orthonormal-row 3 x p blocks by 10 Newton-Schulz
    steps (scaled into the method's convergence region first)."""
    Ab = A.reshape(n, 3, -1)
    scale = torch.sqrt(torch.sum(Ab * Ab, dim=(-2, -1), keepdim=True) / 3.0) * 1.2 + 1e-12
    X = Ab / scale
    for _ in range(10):
        X = 1.5 * X - 0.5 * (X @ X.transpose(-1, -2)) @ X
    return X.reshape(3 * n, -1)


def _staircase_solve(L: torch.Tensor, Y: torch.Tensor, sweeps: int = 100) -> torch.Tensor:
    """Block-coordinate minimization of tr(Y^T L Y) over St(p, 3)^n; rows
    3i..3i+2 of Y (3n, p) are Y_i^T. Each sweep takes the exact per-block
    minimizer polar(-(sum_{j != i} L_ij Y_j)) for every block at once and
    averages it with the current iterate (0.5 damping)."""
    n = L.shape[0] // 3
    blk = torch.kron(torch.eye(n, device=L.device), torch.ones(3, 3, device=L.device))
    W = L - blk * L  # off-diagonal blocks
    for _ in range(sweeps):
        Y = _polar_blocks(Y + _polar_blocks(-(W @ Y), n), n)
    return Y


def _certificate_min_eig(L: torch.Tensor, Y: torch.Tensor, iters: int = 100) -> torch.Tensor:
    """Min eigenvalue of M = L - blockdiag(sym(Y_i^T (L Y)_i)) by shifted
    power iteration (SE-Sync certificate)."""
    n3 = L.shape[0]
    n = n3 // 3
    Yb = Y.reshape(n, 3, -1)
    Lam = torch.einsum("nip,njp->nij", (L @ Y).reshape(n, 3, -1), Yb)
    Lam = 0.5 * (Lam + Lam.transpose(-1, -2))
    idx = torch.arange(n, device=L.device)
    BD = torch.zeros(n, 3, n, 3, dtype=L.dtype, device=L.device)
    BD[idx, :, idx, :] = Lam
    M = L - BD.reshape(n3, n3)
    sigma = torch.linalg.norm(M) + 1.0
    A = sigma * torch.eye(n3, dtype=L.dtype, device=L.device) - M
    v = torch.ones(n3, dtype=L.dtype, device=L.device) / np.sqrt(n3)
    for _ in range(iters):
        w = A @ v
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-20)
    return sigma - v @ (A @ v)


# ---------------------------------------------------------------------------
# Sparse (edge-list, matrix-free) path: L is never materialized; every
# operator is a per-edge gather + index_add over nodes.
# ---------------------------------------------------------------------------


def _neigh_sum(ea, eb, Rmeas, Y):
    """N_i = sum_{e:(a=i)} R_e^T Y_b + sum_{e:(b=i)} R_e Y_a, so that
    (L Y)_i = c_i Y_i - N_i. Y: (n, 3, p)."""
    contrib_a = torch.einsum("eji,ejp->eip", Rmeas, Y[eb])
    contrib_b = torch.einsum("eij,ejp->eip", Rmeas, Y[ea])
    out = torch.zeros_like(Y)
    out.index_add_(0, ea, contrib_a)
    out.index_add_(0, eb, contrib_b)
    return out


def _apply_L(ea, eb, Rmeas, cdiag, Y):
    return cdiag[:, None, None] * Y - _neigh_sum(ea, eb, Rmeas, Y)


def _sparse_chordal_init(ea, eb, Rmeas, cdiag, n: int, max_iters: int = 4096):
    """Anchored chordal initialization (Martinec-Pajdla), matrix-free:
    L_rr Y_r = -L_r0 with Y_0 = I by Jacobi-preconditioned CG, stopped at
    1e-4 relative residual (the float32 rounding floor)."""
    dev = Rmeas.device
    mask = (torch.arange(n, device=dev) != 0).float()[:, None, None]
    E0 = torch.zeros(n, 3, 3, device=dev)
    E0[0] = torch.eye(3, device=dev)

    def A(X):
        return mask * _apply_L(ea, eb, Rmeas, cdiag, mask * X)

    b = -mask * _apply_L(ea, eb, Rmeas, cdiag, E0)
    Minv = (1.0 / cdiag)[:, None, None]
    X = torch.zeros(n, 3, 3, device=dev)
    r = b
    z = Minv * r
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.sqrt(torch.sum(b * b)) + 1e-30
    k = 0
    while k < max_iters and bool(torch.sqrt(torch.sum(r * r)) > 1e-4 * bnorm):
        Ap = A(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        X = X + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = torch.sum(r * z)
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
        k += 1
    return (mask * X + E0).reshape(3 * n, 3), k


def _sparse_staircase_solve(ea, eb, Rmeas, Y, sweeps: int = 100):
    """Edge-operator staircase: (W Y)_i = -N_i, so the per-block minimizer is
    polar(N_i). Same Jacobi damping as the dense path."""
    n = Y.shape[0] // 3
    for _ in range(sweeps):
        N = _neigh_sum(ea, eb, Rmeas, Y.reshape(n, 3, -1)).reshape(3 * n, -1)
        Y = _polar_blocks(Y + _polar_blocks(N, n), n)
    return Y


def _sparse_certificate_min_eig(ea, eb, Rmeas, cdiag, Y, iters: int = 150):
    """Matrix-free certificate; shift from block Gershgorin (2 max deg) plus
    the largest Lambda norm."""
    n3 = Y.shape[0]
    n = n3 // 3
    Yb = Y.reshape(n, 3, -1)
    Lam = torch.einsum("nip,njp->nij", _apply_L(ea, eb, Rmeas, cdiag, Yb), Yb)
    Lam = 0.5 * (Lam + Lam.transpose(-1, -2))
    sigma = 2.0 * torch.max(cdiag) + torch.max(torch.linalg.norm(Lam, dim=(-2, -1))) + 1.0

    def apply_M(v):
        return _apply_L(ea, eb, Rmeas, cdiag, v) - Lam @ v

    v = torch.ones(n, 3, 1, device=Y.device) / np.sqrt(n3)
    for _ in range(iters):
        w = sigma * v - apply_M(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-20)
    return sigma - torch.sum(v * (sigma * v - apply_M(v)))


def _round_to_so3(Y: torch.Tensor) -> torch.Tensor:
    """Rank-3 rounding (3n, p) -> (n, 3, 3); a global reflection (negative
    mean block determinant) flips the subspace sign."""
    n = Y.shape[0] // 3
    _, _, Vt = torch.linalg.svd(Y, full_matrices=False)
    blocks_T = (Y @ Vt[:3].T).reshape(n, 3, 3)
    if float(torch.mean(torch.linalg.det(blocks_T))) < 0:
        blocks_T = -blocks_T
    return lie.project_to_so3(blocks_T.transpose(-1, -2))


def _lift(Y: torch.Tensor, n: int, p: int) -> torch.Tensor:
    """Pad to p columns and project every block onto the Stiefel manifold."""
    if Y.shape[1] < p:
        Y = torch.cat([Y, torch.zeros(3 * n, p - Y.shape[1], dtype=Y.dtype, device=Y.device)], dim=1)
    U, _, Vt = torch.linalg.svd(Y.reshape(n, 3, p), full_matrices=False)
    return (U @ Vt).reshape(3 * n, p)


def run_rotation_averaging(
    num_images: int,
    edges: np.ndarray,  # (E, 2) int (i1, i2)
    i2Ri1: np.ndarray,  # (E, 3, 3)
    p_values: tuple[int, ...] = (3, 5),
    sweeps: int = 100,
    certificate_tol: float = -1e-3,
    method: str = "auto",  # "dense" | "sparse" | "auto"
    sparse_threshold: int = 1024,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, dict]:
    """Returns (wRi (n, 3, 3) with wR0 = I gauge, info dict). Nodes absent
    from all edges get identity (the caller masks them). method="auto" takes
    the dense path below ``sparse_threshold`` cameras, the matrix-free one
    above it."""
    n = num_images
    dev = resolve_device(device)
    if method == "sparse" or (method == "auto" and n >= sparse_threshold):
        return _run_rotation_averaging_sparse(n, edges, i2Ri1, p_values, sweeps, certificate_tol, dev)

    L = torch.as_tensor(build_connection_laplacian(n, edges, i2Ri1), device=dev)
    evals, evecs = torch.linalg.eigh(L)
    Y = evecs[:, :3]
    info = {"chordal_gap": float(evals[3] - evals[2]), "method": "dense"}
    L_norm = float(torch.linalg.norm(L))
    for p in p_values:
        Y = _staircase_solve(L, _lift(Y, n, p), sweeps)
        min_eig = float(_certificate_min_eig(L, Y))
        info[f"certificate_min_eig_p{p}"] = min_eig
        if min_eig > certificate_tol * (1.0 + L_norm):
            break
    return _finalize_rotations(Y, edges, i2Ri1, info)


def _finalize_rotations(Y, edges, i2Ri1, info):
    """Rank-3 rounding -> gauge (wR0 = I) -> keep R or its transposed gauge,
    whichever has the lower chordal cost."""
    R = _round_to_so3(Y)
    R = R[0].T @ R
    Rm = torch.as_tensor(np.asarray(i2Ri1, np.float32), device=R.device)
    cost = _chordal_cost(R, edges, Rm)
    R_alt = R.transpose(-1, -2)
    R_alt = R_alt[0].T @ R_alt
    cost_alt = _chordal_cost(R_alt, edges, Rm)
    if float(cost_alt) < float(cost):
        R, cost = R_alt, cost_alt
    info["final_chordal_cost"] = float(cost)
    return R.cpu().numpy(), info


def _run_rotation_averaging_sparse(n, edges, i2Ri1, p_values, sweeps, certificate_tol, dev):
    """Matrix-free staircase: L applied edge-wise, never materialized."""
    ea = torch.as_tensor(np.asarray(edges[:, 0]), dtype=torch.int64, device=dev)
    eb = torch.as_tensor(np.asarray(edges[:, 1]), dtype=torch.int64, device=dev)
    Rmeas = torch.as_tensor(np.asarray(i2Ri1, np.float32), device=dev)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, np.asarray(edges[:, 0]), 1.0)
    np.add.at(deg, np.asarray(edges[:, 1]), 1.0)
    cdiag = torch.as_tensor(np.where(deg > 0, deg, 1.0).astype(np.float32), device=dev)

    Y, cg_iters = _sparse_chordal_init(ea, eb, Rmeas, cdiag, n)
    info = {"method": "sparse", "chordal_cg_iters": int(cg_iters)}
    L_norm_bound = float(2.0 * np.max(np.maximum(deg, 1.0)))
    for p in p_values:
        Y = _sparse_staircase_solve(ea, eb, Rmeas, _lift(Y, n, p), sweeps)
        min_eig = float(_sparse_certificate_min_eig(ea, eb, Rmeas, cdiag, Y, iters=300))
        info[f"certificate_min_eig_p{p}"] = min_eig
        if min_eig > certificate_tol * (1.0 + L_norm_bound):
            break
    return _finalize_rotations(Y, edges, i2Ri1, info)


def _chordal_cost(wRi: torch.Tensor, edges: np.ndarray, i2Ri1: torch.Tensor) -> torch.Tensor:
    a = torch.as_tensor(np.asarray(edges[:, 0]), dtype=torch.int64, device=wRi.device)
    b = torch.as_tensor(np.asarray(edges[:, 1]), dtype=torch.int64, device=wRi.device)
    pred = wRi[b].transpose(-1, -2) @ wRi[a]
    return torch.sum((pred - i2Ri1) ** 2)


def relative_rotation_errors_deg(wRi: np.ndarray, edges: np.ndarray, i2Ri1: np.ndarray) -> np.ndarray:
    """Per-edge consistency of the estimate with the measurements (metrics),
    on the host."""
    R = torch.as_tensor(np.asarray(wRi, np.float32))
    a = torch.as_tensor(np.asarray(edges[:, 0]), dtype=torch.int64)
    b = torch.as_tensor(np.asarray(edges[:, 1]), dtype=torch.int64)
    pred = R[b].transpose(-1, -2) @ R[a]
    meas = torch.as_tensor(np.asarray(i2Ri1, np.float32))
    return torch.rad2deg(lie.rotation_angular_distance(pred, meas)).numpy()
