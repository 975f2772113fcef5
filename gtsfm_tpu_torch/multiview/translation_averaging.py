"""1dSFM translation averaging: batched MFAS outlier rejection + robust
translation recovery.

Port of gtsfm_tpu/multiview/translation_averaging.py (the reference's
TranslationAveraging1DSFM, gtsfm/averaging/translation/averaging_1dsfm.py:
68-433). Every projection direction runs the greedy minimum-feedback-arc-set
ordering as one lane of a batch; per-direction outlier weights are averaged
and edges with mean relative outlier weight >= 0.125 are dropped. The
projection directions are drawn with numpy's ``default_rng`` exactly as the
JAX package draws them, so both packages use the same directions.

Translation recovery: robust alternating least squares on scaled-direction
residuals (CG on the weighted graph Laplacian), then a damped Gauss-Newton
polish on the chordal direction cost with Huber weights (sigma 0.01, k 1.345).
On CUDA tensors each of the two phases is one launch of the hand-written
kernel ``csrc/ta_recovery.cu`` over an incidence list built once on the host
(``incidence_tensor``); on CPU tensors the plain PyTorch loop
(``_recover_translations_plain``) runs.

Convention: the measurement for edge (i1, i2) is w_i2Ui1 = normalize(wti1 -
wti2), the direction from camera i2 to camera i1 in world coordinates.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.common import tracing
from gtsfm_tpu_torch.ops import cuda_build

MAX_PROJECTION_DIRECTIONS = 2000  # reference averaging_1dsfm.py:53
OUTLIER_WEIGHT_THRESHOLD = 0.125  # reference averaging_1dsfm.py:51
NOISE_SIGMA = 0.01  # reference averaging_1dsfm.py:46 (TranslationRecovery)
HUBER_K = 1.345
MAX_TRACK_MEASUREMENTS_PER_CAMERA = 12  # reference averaging_1dsfm.py:56-58
MIN_TRACK_LEN_FOR_AVERAGING = 3

def sample_projection_directions(
    measurements: np.ndarray,  # (M, 3) unit directions
    num_samples: int,
    method: str = "uniform",
    seed: int = 0,
) -> np.ndarray:
    """Projection directions for the MFAS sweeps (reference
    averaging_1dsfm.py:105-130): "uniform" (isotropic), "measurements" (drawn
    from the measurement set), "kde" (Gaussian KDE in spherical coordinates)
    or "mixed" (half uniform, half measurements)."""
    rng = np.random.default_rng(seed)
    m = np.asarray(measurements, np.float64)

    def uniform(k):
        d = rng.normal(size=(k, 3))
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    def from_measurements(k):
        if m.shape[0] == 0:
            return uniform(k)
        k_eff = min(k, m.shape[0])
        out = m[rng.choice(m.shape[0], k_eff, replace=False)]
        if k_eff < k:
            out = np.concatenate([out, uniform(k - k_eff)])
        return out

    if method == "uniform":
        dirs = uniform(num_samples)
    elif method == "measurements":
        dirs = from_measurements(num_samples)
    elif method == "kde":
        if m.shape[0] < 4:
            dirs = uniform(num_samples)
        else:
            from scipy import stats

            sub = m[rng.choice(m.shape[0], min(m.shape[0], 2000), replace=False)]
            theta = np.arccos(np.clip(sub[:, 2], -1.0, 1.0))
            phi = np.arctan2(sub[:, 1], sub[:, 0])
            try:
                kde = stats.gaussian_kde(np.stack([theta, phi]))
                th, ph = kde.resample(num_samples, seed=rng)
                dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)
            except np.linalg.LinAlgError:  # degenerate (collinear) set
                dirs = uniform(num_samples)
    elif method == "mixed":
        half = num_samples // 2
        dirs = np.concatenate([uniform(num_samples - half), from_measurements(half)])
    else:
        raise ValueError(f"unknown projection sampling method {method}")
    dirs = np.asarray(dirs, np.float32)
    return dirs / np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12)


def _mfas_chunk(proj: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor, n: int) -> torch.Tensor:
    """Greedy MFAS orderings for a chunk of projections (Dc, E) -> outlier
    weight (Dc, E): |proj| where the ordering contradicts the edge."""
    Dc, E = proj.shape
    dev = proj.device
    w_abs = torch.abs(proj)
    pos_dir = proj >= 0
    s_pos = torch.where(pos_dir, w_abs, torch.zeros_like(w_abs))
    s_neg = w_abs - s_pos
    # Dense per-projection adjacency A[d, i, j] = weight of directed edge i->j.
    A = torch.zeros(Dc, n * n, dtype=proj.dtype, device=dev)
    A.index_add_(1, ea * n + eb, s_pos)
    A.index_add_(1, eb * n + ea, s_neg)
    A = A.reshape(Dc, n, n)
    net = A.sum(2) - A.sum(1)  # out - in per node
    B = A - A.transpose(-1, -2)  # the net-tally update reads one row of B
    remaining = torch.ones(Dc, n, dtype=torch.bool, device=dev)
    pos = torch.zeros(Dc, n, dtype=torch.int64, device=dev)
    rows = torch.arange(Dc, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=proj.dtype, device=dev)
    for counter in range(n):
        pick = torch.argmax(torch.where(remaining, net, neg_inf), dim=-1)
        remaining[rows, pick] = False
        pos[rows, pick] = counter
        net = net + B[rows, pick]
    u = torch.where(pos_dir, ea[None], eb[None])
    v = torch.where(pos_dir, eb[None], ea[None])
    pos_u = torch.gather(pos, 1, u)
    pos_v = torch.gather(pos, 1, v)
    return torch.where(pos_u > pos_v, w_abs, torch.zeros_like(w_abs))


def mfas_outlier_weights(
    edges: np.ndarray,  # (E, 2)
    w_directions: np.ndarray,  # (E, 3) world-frame unit directions (w_i2Ui1)
    num_nodes: int,
    num_projections: int = 512,
    seed: int = 0,
    sampling_method: str = "uniform",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Mean relative outlier weight per edge over sampled projections."""
    dev = resolve_device(device)
    n = int(num_nodes)
    dirs = sample_projection_directions(w_directions, num_projections, method=sampling_method, seed=seed)
    ea = torch.as_tensor(np.asarray(edges[:, 1]), dtype=torch.int64, device=dev)  # node i2 ("from")
    eb = torch.as_tensor(np.asarray(edges[:, 0]), dtype=torch.int64, device=dev)  # node i1 ("to")
    proj = torch.as_tensor(dirs, device=dev) @ torch.as_tensor(np.asarray(w_directions, np.float32), device=dev).T
    # Chunk the projections to bound the dense adjacency (A + B = 2 Dc n^2).
    chunk = max(1, min(num_projections, int(2**28 // max(n * n, 1)) or 1))
    outlier_w = torch.cat([_mfas_chunk(proj[s:s + chunk], ea, eb, n)
                           for s in range(0, num_projections, chunk)])
    denom = torch.clamp(torch.abs(proj).sum(0), min=1e-9)
    return (outlier_w.sum(0) / denom).cpu().numpy()


class TranslationResult(NamedTuple):
    wti: np.ndarray  # (n, 3)
    valid: np.ndarray  # (n,) bool — nodes constrained by at least one edge
    inlier_edges: np.ndarray  # (E,) bool


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)


def _pcg(matvec, precond, b, x, iters: int = 40):
    """Fixed-count preconditioned CG from x."""
    rr = b - matvec(x)
    z = precond(rr)
    p = z
    rz = torch.sum(rr * z)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = precond(rr)
        rz_new = torch.sum(rr * z)
        p = z + (rz_new / torch.clamp(rz, min=1e-20)) * p
        rz = rz_new
    return x


def _recover_translations_plain(
    edges_a: torch.Tensor,
    edges_b: torch.Tensor,
    u_meas: torch.Tensor,  # (E, 3) world unit dir from node a toward node b
    w_edge: torch.Tensor,  # (E,) weights (inlier mask)
    t0: torch.Tensor,  # (n, 3) init
    num_nodes: int,
    iters: int = 60,
    gn_iters: int = 15,
    is_metric: torch.Tensor | None = None,  # (E,) {0,1}: u_meas is a full displacement
    sigma_e: torch.Tensor | None = None,  # (E,) per-edge noise sigma
    normalize_gauge: bool = True,
) -> torch.Tensor:
    """Robust alternating least squares on scaled-direction residuals
    (minimize sum_e w_e ||(t_b - t_a) - s_e u_e||^2 with s_e >= 0.05,
    alternating the closed-form scale with a CG solve of the weighted graph
    Laplacian; Huber IRLS after the first third; mean edge scale normalized
    to 1), then a damped Gauss-Newton polish on the chordal direction cost.

    Metric edges (``is_metric`` 1: rig calibration or lidar priors, the
    reference's BinaryMeasurementPoint3 priors in rig_1dsfm.py:25) pin the
    full displacement t_b - t_a = u_e: their scale stays 1 and they fix the
    scale gauge, so the caller passes ``normalize_gauge=False`` with them.
    Edge weights carry (NOISE_SIGMA / sigma_e)^2.

    The plain PyTorch loop, on any device: ``_recover_translations_gn``
    runs it for CPU tensors, and the kernel's tests hold the kernel to it."""
    n = num_nodes
    delta = 0.05
    eye3 = torch.eye(3, dtype=u_meas.dtype, device=u_meas.device)
    if is_metric is None:
        is_metric = torch.zeros_like(u_meas[:, 0])
    if sigma_e is None:
        sigma_e = torch.full_like(u_meas[:, 0], NOISE_SIGMA)
    metric = is_metric > 0
    w_sigma = (NOISE_SIGMA / sigma_e) ** 2
    with tracing.span("back_end/translation_averaging/recovery/irls"):
        t = t0
        for it in range(iters):
            d_vec = t[edges_b] - t[edges_a]
            s = torch.clamp(torch.sum(d_vec * u_meas, dim=-1), min=delta)
            s = torch.where(metric, torch.ones_like(s), s)
            if normalize_gauge:  # mean live-edge scale -> 1
                s_mean = torch.sum(s * w_edge) / torch.clamp(torch.sum(w_edge), min=1e-9)
                s = s / torch.clamp(s_mean, min=1e-9)
                t = t / torch.clamp(s_mean, min=1e-9)
            target = s[:, None] * u_meas
            e = torch.linalg.norm((t[edges_b] - t[edges_a]) - target, dim=-1)
            w_rob = torch.clamp(0.25 / torch.clamp(e, min=1e-9), max=1.0)
            if it < iters // 3:  # first sweeps: plain least squares
                w_rob = torch.ones_like(w_rob)
            w = w_rob * w_edge * w_sigma

            def L_mv(x, w=w):
                y = w[:, None] * (x[edges_b] - x[edges_a])
                return _segment_sum(y, edges_b, n) - _segment_sum(y, edges_a, n) + 1e-6 * x

            rhs = _segment_sum(w[:, None] * target, edges_b, n) - _segment_sum(w[:, None] * target, edges_a, n)
            deg = _segment_sum(w, edges_a, n) + _segment_sum(w, edges_b, n) + 1e-6
            x = _pcg(L_mv, lambda r, deg=deg: r / deg[:, None], rhs, t)
            t = x - torch.mean(x, dim=0, keepdim=True)

    with tracing.span("back_end/translation_averaging/recovery/gauss_newton"):
        for _ in range(gn_iters):
            d_vec = t[edges_b] - t[edges_a]
            dn = torch.clamp(torch.linalg.norm(d_vec, dim=-1, keepdim=True), min=1e-9)
            d = d_vec / dn
            sig = sigma_e[:, None]
            r = torch.where(metric[:, None], (d_vec - u_meas) / sig, (d - u_meas) / sig)
            e = torch.linalg.norm(r, dim=-1)
            w_rob = torch.clamp(HUBER_K / torch.clamp(e, min=1e-9), max=1.0) * w_edge
            P = torch.where(metric[:, None, None], eye3 / sig[..., None],
                            (eye3 - d[:, :, None] * d[:, None, :]) / (dn[..., None] * sig[..., None]))
            JtJ_e = torch.einsum("eki,ekj->eij", P, P) * w_rob[:, None, None]
            Jtr_e = torch.einsum("eki,ek->ei", P, r) * w_rob[:, None]
            Hd = _segment_sum(JtJ_e, edges_a, n) + _segment_sum(JtJ_e, edges_b, n)
            damp = 1e-3 * Hd * eye3 + 1e-8 * eye3
            g = _segment_sum(Jtr_e, edges_b, n) - _segment_sum(Jtr_e, edges_a, n)

            def H_mv(x, JtJ_e=JtJ_e, damp=damp):
                y = torch.einsum("eij,ej->ei", JtJ_e, x[edges_b] - x[edges_a])
                return (_segment_sum(y, edges_b, n) - _segment_sum(y, edges_a, n)
                        + torch.einsum("nij,nj->ni", damp, x))

            Minv = torch.linalg.inv(Hd + damp)
            x = _pcg(H_mv, lambda r, Minv=Minv: torch.einsum("nij,nj->ni", Minv, r), -g, torch.zeros_like(g))
            t = t + (x - torch.mean(x, dim=0, keepdim=True))
    return t


class Incidence(NamedTuple):
    """Each node's incident edges, in a fixed order: the edges whose b end
    it is (sign +1), then, from ``split``, those whose a end it is (sign
    -1), each group by edge index. A node's sum over the first group less
    its sum over the second is ``_segment_sum(y, edges_b) -
    _segment_sum(y, edges_a)``."""

    offsets: np.ndarray  # (n + 1,) int32: node v's incidences are [offsets[v], offsets[v + 1])
    split: np.ndarray  # (n,) int32: its first incidence of sign -1 (offsets[v + 1] if none)
    edge: np.ndarray  # (2E,) int32


def edge_incidence(edges_a: np.ndarray, edges_b: np.ndarray, num_nodes: int) -> Incidence:
    """The incidence list of the directed edges a -> b over ``num_nodes``
    nodes (raises on an index outside them)."""
    ea = np.asarray(edges_a, np.int64)
    eb = np.asarray(edges_b, np.int64)
    if ea.ndim != 1 or ea.shape != eb.shape:
        raise ValueError(f"edge_incidence: edges_a {ea.shape} and edges_b {eb.shape} must be equal 1-D")
    E = ea.shape[0]
    if E and (min(ea.min(), eb.min()) < 0 or max(ea.max(), eb.max()) >= num_nodes):
        raise ValueError(f"edge_incidence: an edge end lies outside the {num_nodes} nodes")
    node = np.concatenate([eb, ea])
    offsets = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(node, minlength=num_nodes), out=offsets[1:])
    split = offsets[:-1] + np.bincount(eb, minlength=num_nodes)
    edge = np.tile(np.arange(E, dtype=np.int64), 2)[np.argsort(node, kind="stable")]
    return Incidence(*(a.astype(np.int32) for a in (offsets, split, edge)))


def _recovery_kernels():
    """The built library's (IRLS, Gauss-Newton, workspace floats) C
    functions."""
    lib = cuda_build.load("ta_recovery")
    fns = (lib.gtsfm_ta_irls_f32, lib.gtsfm_ta_gauss_newton_f32, lib.gtsfm_ta_workspace_floats)
    irls, gn, workspace_floats = fns
    if irls.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        irls.argtypes = [ptr] * 10 + [i32] * 4 + [ptr]
        gn.argtypes = [ptr] * 10 + [i32] * 3 + [ptr]
        irls.restype = gn.restype = i32
        workspace_floats.argtypes = [i32] * 2
        workspace_floats.restype = ctypes.c_longlong
    return fns


def incidence_tensor(edges_a: np.ndarray, edges_b: np.ndarray, num_nodes: int, device) -> torch.Tensor:
    """``edge_incidence``'s offsets, split and edge back to back, as the
    int32 tensor on ``device`` that the recovery kernel reads."""
    inc = edge_incidence(edges_a, edges_b, num_nodes)
    return torch.from_numpy(np.concatenate([inc.offsets, inc.split, inc.edge])).to(device)


def _recover_translations_kernel(edges_a, edges_b, u_meas, w_edge, t0, num_nodes, iters, gn_iters,
                                 is_metric, sigma_e, normalize_gauge, incidence) -> torch.Tensor:
    """``_recover_translations_plain`` on a card: one launch of
    ``csrc/ta_recovery.cu`` per phase, each inside its span, over the
    caller's ``incidence_tensor`` of the edges. Counts its launches in
    ``_recover_translations_kernel.launches``."""
    dev = t0.device
    n, E = int(num_nodes), int(edges_a.shape[0])
    if n <= 0:
        return t0
    if incidence is None:
        raise ValueError("recovery kernel: pass incidence=incidence_tensor(edges_a, edges_b, num_nodes, device)")

    def ready(x, dtype, shape):
        if x is None:
            return None
        if tuple(x.shape) != shape:
            raise ValueError(f"recovery kernel: expected shape {shape}, got {tuple(x.shape)}")
        return x.to(device=dev, dtype=dtype).contiguous()

    ea, eb = (ready(x, torch.int64, (E,)) for x in (edges_a, edges_b))
    u, w = ready(u_meas, torch.float32, (E, 3)), ready(w_edge, torch.float32, (E,))
    metric, sigma = ready(is_metric, torch.float32, (E,)), ready(sigma_e, torch.float32, (E,))
    t_in, inc = ready(t0, torch.float32, (n, 3)), ready(incidence, torch.int32, (2 * n + 1 + 2 * E,))
    t_mid, t_out = torch.empty_like(t_in), torch.empty_like(t_in)
    irls, gn, workspace_floats = _recovery_kernels()
    workspace = torch.empty(workspace_floats(n, E), dtype=torch.float32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    graph = [ptr(x) for x in (ea, eb, u, w, metric, sigma, inc)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with tracing.span("back_end/translation_averaging/recovery/irls"):
            err = irls(*graph, ptr(t_in), ptr(t_mid), ptr(workspace), n, E, int(iters), int(normalize_gauge), stream)
        if err == 0:
            with tracing.span("back_end/translation_averaging/recovery/gauss_newton"):
                err = gn(*graph, ptr(t_mid), ptr(t_out), ptr(workspace), n, E, int(gn_iters), stream)
    if err != 0:
        raise RuntimeError(f"translation recovery kernel launch failed (cudaError {err})")
    _recover_translations_kernel.launches += 2
    return t_out


_recover_translations_kernel.launches = 0


def _recover_translations_gn(
    edges_a: torch.Tensor,
    edges_b: torch.Tensor,
    u_meas: torch.Tensor,  # (E, 3) world unit dir from node a toward node b
    w_edge: torch.Tensor,  # (E,) weights (inlier mask)
    t0: torch.Tensor,  # (n, 3) init
    num_nodes: int,
    iters: int = 60,
    gn_iters: int = 15,
    is_metric: torch.Tensor | None = None,  # (E,) {0,1}: u_meas is a full displacement
    sigma_e: torch.Tensor | None = None,  # (E,) per-edge noise sigma
    normalize_gauge: bool = True,
    incidence: torch.Tensor | None = None,  # incidence_tensor of the edges: needed on a card
) -> torch.Tensor:
    """Robust translation recovery (``_recover_translations_plain`` says
    what it computes): the kernel for CUDA tensors, the plain loop for CPU
    ones."""
    if t0.device.type == "cuda":
        return _recover_translations_kernel(edges_a, edges_b, u_meas, w_edge, t0, num_nodes, iters, gn_iters,
                                            is_metric, sigma_e, normalize_gauge, incidence)
    return _recover_translations_plain(edges_a, edges_b, u_meas, w_edge, t0, num_nodes, iters, gn_iters,
                                       is_metric, sigma_e, normalize_gauge)


def select_tracks_for_averaging(
    cam_idx: np.ndarray,  # (T, L) int, per-track measurement cameras
    track_mask: np.ndarray,  # (T, L) validity
    num_images: int,
    meas_per_camera: int = MAX_TRACK_MEASUREMENTS_PER_CAMERA,
) -> np.ndarray:
    """Greedy cover (reference _select_tracks_for_averaging :273): pick long
    tracks until every camera is covered by ~meas_per_camera track
    measurements. Returns selected track indices."""
    lengths = track_mask.sum(-1)
    order = np.argsort(-lengths)
    need = np.full(num_images, meas_per_camera, np.int64)
    selected = []
    for t in order:
        if lengths[t] < MIN_TRACK_LEN_FOR_AVERAGING:
            break
        cams = cam_idx[t][track_mask[t] > 0]
        if np.any(need[cams] > 0):
            selected.append(t)
            need[cams] -= 1
        if not np.any(need > 0):
            break
    return np.asarray(selected, np.int64)


def run_translation_averaging(
    num_images: int,
    edges: np.ndarray,  # (E, 2) (i1, i2)
    i2Ui1: np.ndarray,  # (E, 3) unit translation dir of i1 in i2 frame
    wRi: np.ndarray,  # (n, 3, 3) global rotations
    num_projections: int = 512,
    seed: int = 0,
    sampling_method: str = "uniform",
    track_cam_idx: np.ndarray | None = None,  # (T, L) optional track cams
    track_rays: np.ndarray | None = None,  # (T, L, 3) unit rays in CAMERA frame
    track_mask: np.ndarray | None = None,  # (T, L)
    prior_edges: np.ndarray | None = None,  # (Q, 2) (i1, i2) metric prior edges
    prior_disp: np.ndarray | None = None,  # (Q, 3) world-frame t_i1 - t_i2
    prior_sigma: np.ndarray | None = None,  # (Q,) noise sigma per prior
    device: str | torch.device = "cuda",
) -> TranslationResult:
    """Full 1dSFM: lift to world, MFAS inliers, robust recovery. Selected
    camera->landmark directions from tracks join the recovery with the
    landmarks as extra unknowns (reference averaging_1dsfm.py). Metric
    priors (world-frame relative positions, the reference's
    BinaryMeasurementsPoint3 from rig calibration or lidar odometry) join
    the recovery with full-displacement residuals and fix the scale gauge."""
    dev = resolve_device(device)
    n = num_images
    wRi = np.asarray(wRi)
    # Lift: w_i2Ui1 = wRi2 @ i2Ui1 (direction from camera i2 toward camera i1).
    w_dirs = np.einsum("eij,ej->ei", wRi[edges[:, 1]], np.asarray(i2Ui1))
    with tracing.span("back_end/translation_averaging/mfas"):
        outlier_w = mfas_outlier_weights(edges, w_dirs, n, num_projections, seed,
                                         sampling_method=sampling_method, device=dev)
    inliers = outlier_w < OUTLIER_WEIGHT_THRESHOLD

    with tracing.span("back_end/translation_averaging/init"):
        # Init: spanning-tree walk over inlier edges with unit lengths.
        rng = np.random.default_rng(seed + 1)
        t0 = rng.normal(size=(n, 3)).astype(np.float32) * 0.01
        adj: dict[int, list[tuple[int, np.ndarray]]] = {}
        for k in np.nonzero(inliers)[0]:
            a, b = int(edges[k, 1]), int(edges[k, 0])  # direction a -> b
            d = w_dirs[k].astype(np.float32)
            adj.setdefault(a, []).append((b, d))
            adj.setdefault(b, []).append((a, -d))
        has_priors = prior_edges is not None and len(prior_edges) > 0
        if has_priors:
            for q in range(len(prior_edges)):
                i1, i2 = int(prior_edges[q, 0]), int(prior_edges[q, 1])
                d = prior_disp[q].astype(np.float32)  # t_i1 - t_i2
                adj.setdefault(i2, []).append((i1, d))
                adj.setdefault(i1, []).append((i2, -d))
        visited = set()
        for root in adj:
            if root in visited:
                continue
            stack = [root]
            visited.add(root)
            while stack:
                cur = stack.pop()
                for nb, d in adj.get(cur, []):
                    if nb not in visited:
                        t0[nb] = t0[cur] + d
                        visited.add(nb)
                        stack.append(nb)

        # Optional camera->landmark measurements (selected tracks as extra nodes).
        n_total = n
        extra_a, extra_b, extra_u = [], [], []
        if track_cam_idx is not None and track_rays is not None and track_mask is not None:
            sel = select_tracks_for_averaging(track_cam_idx, track_mask, n)
            for s_i, t_idx in enumerate(sel):
                node = n + s_i
                for l in np.nonzero(track_mask[t_idx] > 0)[0]:
                    cam = int(track_cam_idx[t_idx, l])
                    w_dir = wRi[cam] @ track_rays[t_idx, l]
                    nrm = np.linalg.norm(w_dir)
                    if nrm < 1e-9:
                        continue
                    extra_a.append(cam)
                    extra_b.append(node)
                    extra_u.append((w_dir / nrm).astype(np.float32))
            n_total = n + len(sel)
            if extra_a:
                t0_2 = np.zeros((n_total, 3), np.float32)
                t0_2[:n] = t0
                for a, b, u_ in zip(extra_a, extra_b, extra_u):
                    if np.allclose(t0_2[b], 0):  # one unit along the first ray
                        t0_2[b] = t0_2[a] + u_
                t0 = t0_2

        def tensor(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        # Edge direction from i2 (a) to i1 (b); prior rows last.
        n_pri = len(prior_edges) if has_priors else 0
        ea_np = np.concatenate([edges[:, 1], np.asarray(extra_a, np.int64)]
                               + ([prior_edges[:, 1]] if has_priors else [])).astype(np.int64)
        eb_np = np.concatenate([edges[:, 0], np.asarray(extra_b, np.int64)]
                               + ([prior_edges[:, 0]] if has_priors else [])).astype(np.int64)
        ea, eb = tensor(ea_np, torch.int64), tensor(eb_np, torch.int64)
        u = tensor(np.concatenate([w_dirs.astype(np.float32)] + ([np.stack(extra_u)] if extra_u else [])
                                  + ([prior_disp.astype(np.float32)] if has_priors else [])))
        is_metric = np.zeros(ea.shape[0], np.float32)
        sigma = np.full(ea.shape[0], NOISE_SIGMA, np.float32)
        if has_priors:
            is_metric[-n_pri:] = 1.0
            sigma[-n_pri:] = np.asarray(prior_sigma, np.float32)
        metric_kw = dict(is_metric=tensor(is_metric), sigma_e=tensor(sigma), normalize_gauge=not has_priors)
        if dev.type == "cuda":  # the kernel's incidence list, once for both calls
            metric_kw["incidence"] = incidence_tensor(ea_np, eb_np, n_total, dev)
        ones = np.ones(len(extra_a) + n_pri, np.float32)
    with tracing.span("back_end/translation_averaging/recovery"):
        t = _recover_translations_gn(ea, eb, u, tensor(np.concatenate([inliers.astype(np.float32), ones])),
                                     tensor(t0), num_nodes=n_total, iters=150, **metric_kw)

    # Second rejection pass: edges off by > 15 degrees after recovery go.
    t_np = t.cpu().numpy()
    d_vec = t_np[edges[:, 0]] - t_np[edges[:, 1]]
    d_norm = d_vec / np.maximum(np.linalg.norm(d_vec, axis=-1, keepdims=True), 1e-9)
    ang = np.degrees(np.arccos(np.clip(np.sum(d_norm * w_dirs, -1), -1, 1)))
    inliers = inliers & (ang < 15.0)
    valid = np.zeros(n, bool)
    valid[edges[inliers, 0]] = True
    valid[edges[inliers, 1]] = True
    with tracing.span("back_end/translation_averaging/recovery"):
        t = _recover_translations_gn(ea, eb, u, tensor(np.concatenate([inliers.astype(np.float32), ones])),
                                     t, num_nodes=n_total, iters=20, gn_iters=15, **metric_kw)
    t = t.cpu().numpy()[:n]
    t = t - t[valid].mean(0, keepdims=True) if valid.any() else t
    return TranslationResult(wti=t, valid=valid, inlier_edges=inliers)


# Hilti rig layout (reference rig_1dsfm.py:25 RigTranslationAveraging1DSFM).
NUM_CAMERAS_IN_RIG = 5
BODY_FRAME_CAMERA = 2
VALID_HARD_CONSTRAINT_EDGES = ((0, 2), (1, 2), (2, 3), (2, 4))


def run_rig_translation_averaging(
    num_images: int,
    edges: np.ndarray,
    i2Ui1: np.ndarray,
    wRi: np.ndarray,
    relative_pose_priors: dict,
    num_cams_in_rig: int = NUM_CAMERAS_IN_RIG,
    body_cam: int = BODY_FRAME_CAMERA,
    **kwargs,
) -> TranslationResult:
    """Rig variant of 1dSFM (reference rig_1dsfm.py:25): relative Pose3
    priors become world-frame relative Point3 priors before recovery.

      * HARD priors (rigid rig calibration) are kept only on the intra-rig
        edges of VALID_HARD_CONSTRAINT_EDGES (camera index within the rig),
        sigma 1e-3.
      * SOFT priors (lidar odometry) are collapsed to one prior between the
        BODY_FRAME_CAMERA nodes of the two rigs, sigma 1e-2.

    ``relative_pose_priors``: {(i1, i2): PosePrior} holding i1Ti2 (wRi =
    i1Ri2, wti = position of camera i2 in camera i1's frame)."""
    from gtsfm_tpu_torch.common.pose_prior import PosePriorType

    R = num_cams_in_rig
    wRi_np = np.asarray(wRi)
    pe, pd, ps = [], [], []
    added = set()
    for (i1, i2), p in relative_pose_priors.items():
        # w(t_i2 - t_i1) = wRi1 @ i1ti2; a prior row (r0, r1) constrains
        # t_r0 - t_r1, so rows are stored as (i2, i1).
        w_disp = wRi_np[i1] @ np.asarray(p.wti)
        if p.type == PosePriorType.HARD_CONSTRAINT:
            c1, c2 = i1 % R, i2 % R
            if (c1, c2) in VALID_HARD_CONSTRAINT_EDGES or (c2, c1) in VALID_HARD_CONSTRAINT_EDGES:
                pe.append((i2, i1))
                pd.append(w_disp)
                ps.append(1e-3)
                added.add((i1, i2))
        else:
            b1, b2 = (i1 // R) * R + body_cam, (i2 // R) * R + body_cam
            if (b1, b2) in added:
                continue
            added.add((b1, b2))
            pe.append((i2, i1))
            pd.append(w_disp)
            ps.append(1e-2)
    if pe:
        kwargs["prior_edges"] = np.asarray(pe, np.int64)
        kwargs["prior_disp"] = np.stack(pd).astype(np.float32)
        kwargs["prior_sigma"] = np.asarray(ps, np.float32)
    return run_translation_averaging(num_images, edges, i2Ui1, wRi, **kwargs)
