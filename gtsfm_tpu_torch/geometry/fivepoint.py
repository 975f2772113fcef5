"""Batched Nistér five-point essential-matrix solver, PyTorch.

Port of gtsfm_tpu/geometry/fivepoint.py (the minimal solver inside
cv2.findEssentialMat that the reference's USAC runs,
gtsfm/frontend/verifier/ransac.py:74). A (..., 5, 2) batch of minimal samples
maps to a (..., 10, 3, 3) batch of essential-matrix candidates plus a
validity mask, with no data-dependent control flow:

* nullspace of the 5x9 epipolar system: the projector
  P = I - A^T (A A^T)^-1 A (unrolled 5x5 Cholesky) applied to a fixed probe,
  then modified Gram-Schmidt;
* the ten cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0) are
  expanded by a small polynomial-arithmetic helper on monomial dicts whose
  coefficients are batched tensors (the expansion runs in Python, once per
  call; the tensor work is elementwise);
* a swap-free Gauss-Jordan reduction of the 10x20 system;
* the degree-10 determinant polynomial's real roots by sampling its
  homogeneous form over the real projective line, bracket refinement and a
  guarded Newton polish, then a Gauss-Newton polish of (x, y, z) against the
  pre-elimination system.

Top-k selections break ties by the lowest index, as ``lax.top_k`` does, so
the candidate slots match the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gtsfm_tpu_torch.common.topk import topk_lowest_index

# Fixed probe for extracting a nullspace basis from the projector.
_PROBE = np.array(
    [
        [0.347, -0.912, 0.511, 0.206],
        [-0.781, 0.254, 0.863, -0.442],
        [0.529, 0.678, -0.190, 0.935],
        [0.114, -0.365, -0.742, 0.587],
        [-0.636, 0.481, 0.297, -0.158],
        [0.842, 0.129, -0.554, 0.371],
        [-0.263, -0.797, 0.408, 0.664],
        [0.591, 0.336, 0.925, -0.273],
        [-0.458, 0.703, -0.081, 0.812],
    ],
    dtype=np.float32,
)

# Nistér monomial ordering for the 10x20 system (x, y, z exponents). The
# first 10 columns are eliminated; the trailing 10 are
# [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1].
_MONOMIALS = (
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
)

_GRID = 128  # theta intervals over the projective line


def _chol5_solve(G: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (G + eps I) X = B for SPD 5x5 G, unrolled. G: (..., 5, 5);
    B: (..., 5, k). Returns (..., 5, k)."""
    n = 5
    eps = 1e-9 * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) + 1e-30
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = G[..., i, j] + eps if i == j else G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30)) if i == j else s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    return torch.stack(x, dim=-2)


def _nullspace_basis(A: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of null(A) for batched (..., 5, 9) A -> (..., 4, 9).
    The projector is applied three times: each application divides the
    Cholesky-jitter residual along row(A) again, which keeps near-degenerate
    samples usable; Gram-Schmidt runs twice to re-orthogonalize."""
    At = A.transpose(-1, -2)
    G = A @ At
    V = torch.as_tensor(_PROBE, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (9, 4))
    for _ in range(3):
        V = V - At @ _chol5_solve(G, A @ V)
    cols = [V[..., i] for i in range(4)]
    for _ in range(2):
        basis = []
        for i in range(4):
            v = cols[i]
            for u in basis:
                v = v - torch.sum(v * u, dim=-1, keepdim=True) * u
            v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)
            basis.append(v)
        cols = basis
    return torch.stack(basis, dim=-2)


def _pmul(p: dict, q: dict) -> dict:
    out: dict = {}
    for m1, c1 in p.items():
        for m2, c2 in q.items():
            m = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
            out[m] = out[m] + c1 * c2 if m in out else c1 * c2
    return out


def _padd(p: dict, q: dict, scale=1.0) -> dict:
    out = dict(p)
    for m, c in q.items():
        out[m] = out[m] + scale * c if m in out else scale * c
    return out


def _constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """Expand det(E)=0 and 2 E E^T E - tr(E E^T) E = 0 (halved) into the
    10x20 Nistér coefficient matrix. basis: (..., 4, 9) with
    E = x B0 + y B1 + z B2 + B3. Returns (..., 10, 20)."""
    batch = basis.shape[:-2]
    B = basis.reshape(batch + (4, 3, 3))
    mono1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    Ep = [[{mono1[k]: B[..., k, i, j] for k in range(4)} for j in range(3)] for i in range(3)]
    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i + 1):
            acc: dict = {}
            for k in range(3):
                acc = _padd(acc, _pmul(Ep[i][k], Ep[j][k]))
            EEt[i][j] = acc
            EEt[j][i] = acc
    trace = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    det: dict = {}
    for (i, j, k, s) in ((0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
                         (2, 1, 0, -1.0), (0, 2, 1, -1.0), (1, 0, 2, -1.0)):
        det = _padd(det, _pmul(_pmul(Ep[0][i], Ep[1][j]), Ep[2][k]), s)
    eqs = [det]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(EEt[i][k], Ep[k][j]))
            eqs.append(_padd(acc, _pmul(trace, Ep[i][j]), -0.5))
    zeros = torch.zeros(batch, dtype=basis.dtype, device=basis.device)
    rows = [torch.stack([eq.get(m, zeros) for m in _MONOMIALS], dim=-1) for eq in eqs]
    return torch.stack(rows, dim=-2)


def _gauss_jordan_10x20(M: torch.Tensor):
    """Branch-free Gauss-Jordan reduction of (..., 10, 20) to [I | A'] with
    swap-free partial pivoting (each round picks its pivot among the unused
    rows; one final permutation orders the rows). Returns (A' (..., 10, 10),
    valid (...,) bool)."""
    batch = M.shape[:-2]
    scale = torch.amax(torch.abs(M), dim=(-2, -1))
    valid = torch.ones(batch, dtype=torch.bool, device=M.device)
    used = torch.zeros(batch + (10,), dtype=M.dtype, device=M.device)
    row_of_col = []
    for j in range(10):
        col = torch.where(used > 0, -math.inf, torch.abs(M[..., :, j]))
        p = torch.argmax(col, dim=-1)
        oh = torch.nn.functional.one_hot(p, 10).to(M.dtype)
        piv_row = torch.einsum("...i,...ik->...k", oh, M)
        piv = piv_row[..., j]
        valid = valid & (torch.abs(piv) > 1e-12 * scale)
        piv = torch.where(torch.abs(piv) > 1e-30, piv, torch.full_like(piv, 1e-30))
        piv_row = piv_row / piv[..., None]
        fac = M[..., :, j] * (1.0 - oh)
        M = M - fac[..., None] * piv_row[..., None, :]
        M = torch.where(oh[..., None] > 0, piv_row[..., None, :], M)
        used = used + oh
        row_of_col.append(p)
    perm = torch.stack(row_of_col, dim=-1)
    M = torch.gather(M, -2, perm[..., None].expand(perm.shape + (20,)))
    return M[..., :, 10:], valid


def _polymul(a: list, b: list) -> list:
    out = [None] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            out[i + j] = t if out[i + j] is None else out[i + j] + t
    return out


def _polysub(a: list, b: list) -> list:
    out = []
    for i in range(max(len(a), len(b))):
        ai = a[i] if i < len(a) else None
        bi = b[i] if i < len(b) else None
        out.append(-bi if ai is None else (ai if bi is None else ai - bi))
    return out


def _det_polynomial(Ap: torch.Tensor):
    """From the reduced block A' build B(z) (rows <k>, <l>, <m> of Nistér) and
    its degree-10 determinant. Returns (coeffs (..., 11) low-to-high, Brows)."""
    def row_pair(r1, r2):
        def a(r, c):
            return Ap[..., r, c]
        px = [a(r1, 2), a(r1, 1) - a(r2, 2), a(r1, 0) - a(r2, 1), -a(r2, 0)]
        py = [a(r1, 5), a(r1, 4) - a(r2, 5), a(r1, 3) - a(r2, 4), -a(r2, 3)]
        p1 = [a(r1, 9), a(r1, 8) - a(r2, 9), a(r1, 7) - a(r2, 8),
              a(r1, 6) - a(r2, 7), -a(r2, 6)]
        return [px, py, p1]

    Brows = [row_pair(4, 5), row_pair(6, 7), row_pair(8, 9)]
    (k_x, k_y, k_1), (l_x, l_y, l_1), (m_x, m_y, m_1) = Brows
    det = _polymul(k_x, _polysub(_polymul(l_y, m_1), _polymul(l_1, m_y)))
    det = _polysub(det, _polymul(k_y, _polysub(_polymul(l_x, m_1), _polymul(l_1, m_x))))
    t3 = _polymul(k_1, _polysub(_polymul(l_x, m_y), _polymul(l_y, m_x)))
    coeffs = []
    for i in range(max(len(det), len(t3))):
        d = det[i] if i < len(det) else None
        t = t3[i] if i < len(t3) else None
        coeffs.append(t if d is None else (d if t is None else d + t))
    return torch.stack(coeffs, dim=-1), Brows


def _eval_homogeneous(coeffs: torch.Tensor, s: torch.Tensor, c: torch.Tensor):
    """q = sum_k coeffs[..., k] s^k c^(10-k); s, c carry one extra trailing
    axis beyond coeffs' batch."""
    sp = [torch.ones_like(s)]
    cp = [torch.ones_like(c)]
    for _ in range(10):
        sp.append(sp[-1] * s)
        cp.append(cp[-1] * c)
    q = None
    for k in range(11):
        t = coeffs[..., k, None] * sp[k] * cp[10 - k]
        q = t if q is None else q + t
    return q


def _real_roots_deg10(coeffs: torch.Tensor):
    """All real roots of the degree-10 polynomial, batched. coeffs: (..., 11)
    low-to-high. Returns (z (..., 10), found (..., 10)).

    The homogeneous form is sampled over the whole projective line (coarse
    grid: sign changes and near-zero |q| minima), the top-10 coarse brackets
    are resampled on a fine subgrid (splitting near-double roots), each
    chosen cell is subdivided 64 ways, then a guarded Newton polish."""
    dtype, dev = coeffs.dtype, coeffs.device
    cmax = torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
    cn = coeffs / torch.clamp(cmax, min=1e-30)

    def qeval(t):
        return _eval_homogeneous(cn, torch.sin(t), torch.cos(t))

    theta = torch.linspace(-math.pi / 2, math.pi / 2, _GRID + 1, dtype=torch.float64)
    theta = theta.to(dtype=dtype, device=dev)
    q = qeval(theta)
    aq = torch.abs(q)
    qscale = torch.amax(aq, dim=-1)[..., None]
    sc = ((q[..., :-1] * q[..., 1:]) < 0.0).to(dtype) * 2.0
    lm = (aq[..., 1:-1] <= aq[..., :-2]) & (aq[..., 1:-1] <= aq[..., 2:])
    lm = lm & (aq[..., 1:-1] < 3e-2 * qscale)
    lm = lm.to(dtype) / (1.0 + aq[..., 1:-1])
    _, cidx = topk_lowest_index(torch.cat([sc, lm], dim=-1), 10)
    c_is_sc = cidx < _GRID
    h = math.pi / _GRID
    j_lm = cidx - _GRID + 1
    c_lo = torch.where(c_is_sc, -math.pi / 2 + cidx * h, -math.pi / 2 + (j_lm - 1) * h).to(dtype)
    c_hi = torch.where(c_is_sc, -math.pi / 2 + (cidx + 1) * h, -math.pi / 2 + (j_lm + 1) * h).to(dtype)

    # Fine pass: F subintervals inside each of the 10 coarse brackets, two
    # candidate slots per bracket feeding a 20-lane top-10.
    F = 32
    offs = torch.linspace(0.0, 1.0, F + 1, dtype=torch.float64).to(dtype=dtype, device=dev)
    tf = c_lo[..., None] + (c_hi - c_lo)[..., None] * offs
    qf = _eval_homogeneous(cn[..., None, :], torch.sin(tf), torch.cos(tf))
    aqf = torch.abs(qf)
    f_sc = ((qf[..., :-1] * qf[..., 1:]) < 0.0).to(dtype) * 2.0
    f_lm = (aqf[..., 1:-1] <= aqf[..., :-2]) & (aqf[..., 1:-1] <= aqf[..., 2:])
    f_lm = f_lm & (aqf[..., 1:-1] < 3e-2 * qscale[..., None])
    f_lm = f_lm.to(dtype) / (1.0 + aqf[..., 1:-1])
    scores_b = torch.cat([f_sc, f_lm], dim=-1)
    lane_f = torch.arange(scores_b.shape[-1], device=dev)
    s1, a1 = torch.max(scores_b, dim=-1)
    m2 = torch.where(lane_f == a1[..., None], -math.inf, scores_b)
    s2, a2 = torch.max(m2, dim=-1)
    lead = scores_b.shape[:-2]
    cand_s = torch.stack([s1, s2], -1).reshape(lead + (20,))
    cand_l = torch.stack([a1, a2], -1).reshape(lead + (20,))
    top, sel = topk_lowest_index(cand_s, 10)
    found = top > 0.0
    local = torch.gather(cand_l, -1, sel)
    bsel = sel // 2
    from_sc = local < F
    hf = (c_hi - c_lo) / F
    lo0 = torch.gather(c_lo, -1, bsel)
    hstep = torch.gather(hf, -1, bsel)
    lo = torch.where(from_sc, lo0 + local * hstep, lo0 + (local - F) * hstep)
    hi = torch.where(from_sc, lo0 + (local + 1) * hstep, lo0 + (local - F + 2) * hstep)

    # Refinement: one 64-point subdivision of each candidate cell.
    F2 = 64
    offs2 = torch.linspace(0.0, 1.0, F2 + 1, dtype=torch.float64).to(dtype=dtype, device=dev)
    t2 = lo[..., None] + (hi - lo)[..., None] * offs2
    q2 = _eval_homogeneous(cn[..., None, :], torch.sin(t2), torch.cos(t2))
    aq2 = torch.abs(q2)
    sc2 = (q2[..., :-1] * q2[..., 1:]) < 0.0
    any_sc = torch.any(sc2, dim=-1)
    i_sc2 = torch.argmax(sc2.to(dtype), dim=-1)  # first sign-change cell
    i_mn = torch.argmin(aq2, dim=-1)
    h2 = (hi - lo) / F2
    t_sc = lo + (i_sc2.to(dtype) + 0.5) * h2
    t_mn = lo + i_mn.to(dtype) * h2
    t_root = torch.where(from_sc & any_sc, t_sc, t_mn)

    def qprime(t):
        s, c = torch.sin(t), torch.cos(t)
        sp = [torch.ones_like(s)]
        cp = [torch.ones_like(c)]
        for _ in range(11):
            sp.append(sp[-1] * s)
            cp.append(cp[-1] * c)
        dq = None
        for k in range(11):
            term = 0.0
            if k > 0:
                term = k * sp[k - 1] * cp[11 - k]
            if k < 10:
                term = term - (10 - k) * sp[k + 1] * cp[9 - k]
            t_k = cn[..., k, None] * term
            dq = t_k if dq is None else dq + t_k
        return dq

    q_cur = qeval(t_root)
    for _ in range(3):
        dq = qprime(t_root)
        step = q_cur / torch.where(torch.abs(dq) < 1e-30, torch.full_like(dq, 1e-30), dq)
        t_new = t_root - torch.clamp(step, -h, h)
        q_new = qeval(t_new)
        better = torch.abs(q_new) < torch.abs(q_cur)
        t_root = torch.where(better, t_new, t_root)
        q_cur = torch.where(better, q_new, q_cur)

    s, c = torch.sin(t_root), torch.cos(t_root)
    tiny = torch.where(c < 0, torch.full_like(c, -1e-18), torch.full_like(c, 1e-18))
    z = s / torch.where(torch.abs(c) < 1e-18, tiny, c)
    return torch.clamp(z, -1e6, 1e6), found


def _polish_xyz(M: torch.Tensor, x, y, z, iters: int = 2):
    """Guarded Gauss-Newton on the 10 cubic constraints (the pre-elimination
    matrix M is accurate to ~1e-6, the eliminated polynomial's roots only to
    ~1e-4 in f32). M: (..., 10, 20); x, y, z: (..., R)."""

    def monos_and_grads(x, y, z):
        def pows(v):
            return [torch.ones_like(v), v, v * v, v * v * v]
        px, py, pz = pows(x), pows(y), pows(z)
        zero = torch.zeros_like(x)
        vals, dxs, dys, dzs = [], [], [], []
        for (i, j, k) in _MONOMIALS:
            vals.append(px[i] * py[j] * pz[k])
            dxs.append(i * px[i - 1] * py[j] * pz[k] if i else zero)
            dys.append(j * px[i] * py[j - 1] * pz[k] if j else zero)
            dzs.append(k * px[i] * py[j] * pz[k - 1] if k else zero)
        return tuple(torch.stack(lst, dim=-1) for lst in (vals, dxs, dys, dzs))

    def apply(v):
        return torch.einsum("...ec,...rc->...re", M, v)

    for _ in range(iters):
        v, dx, dy, dz = monos_and_grads(x, y, z)
        r, Jx, Jy, Jz = apply(v), apply(dx), apply(dy), apply(dz)
        a = torch.sum(Jx * Jx, -1)
        b = torch.sum(Jx * Jy, -1)
        c = torch.sum(Jx * Jz, -1)
        d = torch.sum(Jy * Jy, -1)
        e = torch.sum(Jy * Jz, -1)
        f = torch.sum(Jz * Jz, -1)
        lam = 1e-8 * (a + d + f) + 1e-30
        a, d, f = a + lam, d + lam, f + lam
        g1 = torch.sum(Jx * r, -1)
        g2 = torch.sum(Jy * r, -1)
        g3 = torch.sum(Jz * r, -1)
        det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
        det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
        sx = ((d * f - e * e) * g1 + (c * e - b * f) * g2 + (b * e - c * d) * g3) / det
        sy = ((c * e - b * f) * g1 + (a * f - c * c) * g2 + (b * c - a * e) * g3) / det
        sz = ((b * e - c * d) * g1 + (b * c - a * e) * g2 + (a * d - b * b) * g3) / det
        xn, yn, zn = x - sx, y - sy, z - sz
        r2 = apply(monos_and_grads(xn, yn, zn)[0])
        better = torch.sum(r2 * r2, -1) < torch.sum(r * r, -1)
        x = torch.where(better, xn, x)
        y = torch.where(better, yn, y)
        z = torch.where(better, zn, z)
    return x, y, z


def essential_from_five_point(x1: torch.Tensor, x2: torch.Tensor):
    """Nistér 5-point solver, batched over leading dims.

    x1, x2: (..., 5, 2) normalized correspondences with x2h^T E x1h = 0.
    Returns E (..., 10, 3, 3) Frobenius-normalized candidates (unused slots
    hold garbage) and valid (..., 10) bool.
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    basis = _nullspace_basis(A)
    M = _constraint_matrix(basis)
    Ap, valid_elim = _gauss_jordan_10x20(M)
    coeffs, Brows = _det_polynomial(Ap)
    z, found = _real_roots_deg10(coeffs)

    # Back-substitute x, y: [x, y, 1] is the cross product of two rows of
    # B(z); take the pair whose cross has the largest |w| component.
    def eval_poly(p: list, zz: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros_like(zz)
        for c in reversed(p):
            acc = acc * zz + c[..., None]
        return acc

    rows = [torch.stack([eval_poly(px, z), eval_poly(py, z), eval_poly(p1, z)], dim=-1)
            for (px, py, p1) in Brows]
    crosses = torch.stack([torch.linalg.cross(rows[0], rows[1]),
                           torch.linalg.cross(rows[0], rows[2]),
                           torch.linalg.cross(rows[1], rows[2])], dim=-2)
    pick = torch.argmax(torch.abs(crosses[..., 2]), dim=-1)
    v = torch.gather(crosses, -2, pick[..., None, None].expand(pick.shape + (1, 3)))[..., 0, :]
    w = v[..., 2]
    w_safe = torch.where(torch.abs(w) < 1e-20, torch.full_like(w, 1e-20), w)
    x = v[..., 0] / w_safe
    y = v[..., 1] / w_safe
    ok_xy = torch.abs(w) > 1e-12 * torch.linalg.vector_norm(v, dim=-1)
    x, y, z = _polish_xyz(M, x, y, z)

    Bm = basis.reshape(basis.shape[:-2] + (4, 3, 3))
    E = (x[..., None, None] * Bm[..., None, 0, :, :]
         + y[..., None, None] * Bm[..., None, 1, :, :]
         + z[..., None, None] * Bm[..., None, 2, :, :]
         + Bm[..., None, 3, :, :])
    norm = torch.linalg.vector_norm(E, dim=(-2, -1), keepdim=True)
    E = E / torch.clamp(norm, min=1e-20)
    # |det| of the unit-Frobenius E measures how far a poorly refined root
    # left the essential variety.
    det = (E[..., 0, 0] * (E[..., 1, 1] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 1])
           - E[..., 0, 1] * (E[..., 1, 0] * E[..., 2, 2] - E[..., 1, 2] * E[..., 2, 0])
           + E[..., 0, 2] * (E[..., 1, 0] * E[..., 2, 1] - E[..., 1, 1] * E[..., 2, 0]))
    valid = (found & ok_xy & valid_elim[..., None]
             & torch.all(torch.isfinite(E).flatten(-2), dim=-1)
             & (norm[..., 0, 0] > 1e-20) & (torch.abs(det) < 3e-3))
    return E, valid
