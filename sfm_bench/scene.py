"""The benchmark's inputs: the survey's geometry (the configuration's
scene, its images in an order drawn from the run's seed), its
renders on the device, the known-scene features, and a loader that hands
them to the program.

The arithmetic is the synthetic aerial survey's (a serpentine capture of a
textured height field, near-nadir cameras with small random tilts), written
again here in PyTorch so that 128 renders take a fraction of a second on the
card instead of about a second each of host numpy. The reference reads the
same geometry (``Survey``) and never the program's loader.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# Value-noise hash constants of the survey's texture and terrain.
_H1, _H2, _H3 = 73856093, 19349663, 0x5BD1E995


@dataclass
class Survey:
    """Cameras (camera-to-world wRi, centres wti), intrinsics and terrain of
    one seed's survey."""

    num_images: int
    height: int
    width: int
    focal: float
    wRi: np.ndarray  # (N, 3, 3) float64
    wti: np.ndarray  # (N, 3) float64
    foot: float  # ground footprint of one image at the nominal altitude
    altitude: float
    terrain_amp: float
    terrain_salt: int
    tex_salt: int
    tex_octaves: int
    slot: np.ndarray  # (N,) each image's place on the flight path
    seed: int  # the scene's

    def cal(self) -> np.ndarray:
        """Cal3Bundler (f, k1, k2, u0, v0) of every camera, (N, 5) float32."""
        one = np.asarray([self.focal, 0.0, 0.0, self.width / 2.0, self.height / 2.0], np.float32)
        return np.tile(one, (self.num_images, 1))

    def is_valid_pair(self, i: int, j: int) -> bool:
        """Footprint-overlap pairing: neighbours along the flight path and
        any two cameras whose ground centres lie within 0.9 of a footprint."""
        if not 0 <= i < j < self.num_images:
            return False
        if abs(int(self.slot[i]) - int(self.slot[j])) <= 3:
            return True
        return float(np.linalg.norm(self.wti[i, :2] - self.wti[j, :2])) <= 0.9 * self.foot

    def pairs(self) -> list[tuple[int, int]]:
        """Every valid pair in (i, j) order: what exhaustive retrieval keeps."""
        n = self.num_images
        return [(i, j) for i in range(n) for j in range(i + 1, n) if self.is_valid_pair(i, j)]


def _small_rotation(axis_angle: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(axis_angle))
    if theta < 1e-12:
        return np.eye(3)
    k = axis_angle / theta
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64)
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * K @ K


def make_survey(seed: int, num_images: int, rows: int, height: int, width: int, focal: float,
                altitude: float = 10.0, terrain_relief: float = 3.5, order_seed: int | None = None) -> Survey:
    """The survey of ``seed`` (the cameras' heights and tilts, the terrain
    and the texture). With ``order_seed`` its images come in the order of a
    random permutation drawn from it, as a user's upload order: the same
    scene and work, another order."""
    rng = np.random.default_rng(seed)
    cols = (num_images + rows - 1) // rows
    foot = altitude * width / focal
    x_span = (cols - 1) * foot * 0.25
    y_span = (rows - 1) * foot * 0.5
    xs = foot + np.linspace(0.0, x_span, cols)
    ys = foot + np.linspace(0.0, y_span, rows) if rows > 1 else np.asarray([foot])
    flip = np.diag([1.0, -1.0, -1.0])  # camera +z looks down
    centres, rots = [], []
    for r in range(rows):
        for x in (xs if r % 2 == 0 else xs[::-1]):
            if len(centres) >= num_images:
                break
            centres.append([x, ys[r], altitude + rng.normal() * 0.8])
            rots.append(_small_rotation(rng.normal(size=3) * 0.12) @ flip)
    px_world = altitude / focal
    tex_octaves = max(2, int(np.ceil(np.log2(max(foot / (3.0 * px_world), 2.0)))) + 1)
    slot = np.arange(num_images)
    if order_seed is not None:
        slot = np.random.default_rng(order_seed).permutation(num_images)
    return Survey(num_images=num_images, height=height, width=width, focal=float(focal),
                  wRi=np.asarray(rots, np.float64)[slot], wti=np.asarray(centres, np.float64)[slot], foot=foot,
                  altitude=altitude, terrain_amp=min(terrain_relief, 0.26 * foot),
                  terrain_salt=int(rng.integers(1, 2**31)), tex_salt=int(rng.integers(1, 2**31)),
                  tex_octaves=tex_octaves, slot=slot, seed=int(seed))


def _hash01(ix: torch.Tensor, iy: torch.Tensor, salt: int) -> torch.Tensor:
    h = (ix * _H1) ^ (iy * _H2) ^ salt
    h = (h ^ (h >> 13)) * _H3
    h = h ^ (h >> 15)
    return (h & 0xFFFFFF).to(torch.float64) / float(0x1000000)


def value_noise(x: torch.Tensor, y: torch.Tensor, salt: int) -> torch.Tensor:
    """Smooth aperiodic value noise: a hashed lattice, smoothstep-bilinear."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)
    ix, iy = x0.to(torch.int64), y0.to(torch.int64)
    return (_hash01(ix, iy, salt) * (1 - fx) * (1 - fy) + _hash01(ix + 1, iy, salt) * fx * (1 - fy)
            + _hash01(ix, iy + 1, salt) * (1 - fx) * fy + _hash01(ix + 1, iy + 1, salt) * fx * fy)


def terrain_height(s: Survey, x, y):
    """Height of the terrain at (x, y): three octaves pinned to the
    footprint, zero-centred. Takes tensors or numpy arrays."""
    as_np = not torch.is_tensor(x)
    if as_np:
        x, y = torch.as_tensor(np.asarray(x, np.float64)), torch.as_tensor(np.asarray(y, np.float64))
    c, salt = s.foot, s.terrain_salt
    v = (0.55 * value_noise(x / c, y / c, salt) + 0.25 * value_noise(2.0 * x / c, 2.0 * y / c, salt + 7)
         + 0.20 * value_noise(4.0 * x / c, 4.0 * y / c, salt + 13))
    h = (v - 0.5) * s.terrain_amp
    return h.numpy() if as_np else h


def render(s: Survey, device: torch.device, batch: int = 16) -> np.ndarray:
    """Every image of the survey as (N, H, W) uint8, ray-cast on the device:
    a fixed-point ray/terrain intersection (12 steps) and a multi-octave
    albedo, contrast-normalised per image, shaded by height."""
    H, W, f = s.height, s.width, s.focal
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float64),
                            torch.arange(W, device=device, dtype=torch.float64), indexing="ij")
    d_cam = torch.stack([(xs - W / 2.0) / f, (ys - H / 2.0) / f, torch.ones_like(xs)], -1)
    out = np.empty((s.num_images, H, W), np.uint8)
    for b0 in range(0, s.num_images, batch):
        R = torch.as_tensor(s.wRi[b0:b0 + batch], device=device)
        c = torch.as_tensor(s.wti[b0:b0 + batch], device=device)[:, None, None, :]
        d = torch.einsum("hwk,bjk->bhwj", d_cam, R)  # rays in the world
        t = -c[..., 2] / d[..., 2]
        for _ in range(12):
            hh = terrain_height(s, c[..., 0] + t * d[..., 0], c[..., 1] + t * d[..., 1])
            t = (hh - c[..., 2]) / d[..., 2]
        px, py = c[..., 0] + t * d[..., 0], c[..., 1] + t * d[..., 1]
        albedo = torch.zeros_like(px)
        for k in range(s.tex_octaves):
            freq = (2.0**k) / s.foot
            albedo += 0.9**k * value_noise(px * freq, py * freq, s.tex_salt + k)
        mean = albedo.mean(dim=(1, 2), keepdim=True)
        std = albedo.std(dim=(1, 2), correction=0, keepdim=True).clamp(min=1e-6)
        albedo = torch.clamp((albedo - mean) / std * 0.22 + 0.55, 0.0, 1.0)
        shade = 0.75 + 0.25 * (terrain_height(s, px, py) / max(s.terrain_amp, 1e-9) + 0.5)
        img = torch.clamp(albedo * shade * 255.0, 0, 255).to(torch.uint8)
        out[b0:b0 + batch] = img.cpu().numpy()
    return out


@dataclass
class KnownFeatures:
    """Per-image keypoints (N, K, 2), descriptors (N, K, D) and the ground
    truth behind them: the landmark index of each slot (-1 for clutter)."""

    uv: np.ndarray
    descriptor: np.ndarray
    landmark: np.ndarray
    landmarks: np.ndarray  # (L, 3) world points


def known_features(s: Survey, seed: int, device: torch.device, max_keypoints: int, keep: float = 0.7,
                   density: float = 20.0, uv_noise_px: float = 0.5, desc_noise: float = 0.05,
                   dim: int = 256) -> KnownFeatures:
    """Features of a scene with known geometry, in place of a detector:
    terrain landmarks (``density`` per unit area) with a fixed random
    priority and unit descriptor; each image takes up to ``keep`` of its
    slots from its visible landmarks of highest priority (``uv_noise_px`` of
    noise, ``desc_noise`` per descriptor component, renormalised) and fills
    the rest with clutter, in shuffled order. The landmarks are the scene's
    (drawn from its seed); the noise, the clutter and the order are drawn
    from ``seed``, on the device."""
    g_lm = torch.Generator(device=device).manual_seed(s.seed % (2**63))
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    lo = torch.as_tensor(s.wti[:, :2].min(0) - s.foot, device=device)
    hi = torch.as_tensor(s.wti[:, :2].max(0) + s.foot, device=device)
    n_lm = int(density * float(torch.prod(hi - lo)))
    xy = lo + (hi - lo) * torch.rand(n_lm, 2, generator=g_lm, device=device, dtype=torch.float64)
    X = torch.cat([xy, terrain_height(s, xy[:, 0], xy[:, 1])[:, None]], -1)
    priority = torch.rand(n_lm, generator=g_lm, device=device)
    desc = torch.nn.functional.normalize(torch.randn(n_lm, dim, generator=g_lm, device=device), dim=-1)
    n_keep, K, N = int(keep * max_keypoints), max_keypoints, s.num_images
    R = torch.as_tensor(s.wRi, device=device)
    c = torch.as_tensor(s.wti, device=device)
    pc = torch.einsum("lk,nkj->nlj", X, R) - torch.einsum("nk,nkj->nj", c, R)[:, None]  # (N, L, 3)
    z = pc[..., 2].clamp(min=1e-9)
    uv = s.focal * pc[..., :2] / z[..., None] + torch.tensor([s.width / 2.0, s.height / 2.0], device=device,
                                                              dtype=torch.float64)
    vis = (pc[..., 2] > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < s.width) & (uv[..., 1] >= 0) & (uv[..., 1] < s.height)
    # the visible landmarks of highest priority first
    rank = torch.where(vis, priority[None].expand(N, -1), torch.full_like(priority[None].expand(N, -1), -1.0))
    order = torch.argsort(rank, dim=1, descending=True, stable=True)[:, :n_keep]
    taken = torch.gather(vis, 1, order)  # (N, n_keep): a visible landmark in this slot
    lm = torch.where(taken, order, torch.full_like(order, -1))
    kp = torch.gather(uv, 1, order[..., None].expand(-1, -1, 2))
    kp = kp + uv_noise_px * torch.randn(kp.shape, generator=g, device=device, dtype=torch.float64)
    d = desc[order] + desc_noise * torch.randn(N, n_keep, dim, generator=g, device=device)
    # clutter: a uniform position and a random descriptor
    n_cl = K - n_keep
    size = torch.tensor([s.width, s.height], device=device, dtype=torch.float64)
    kp_cl = torch.rand(N, n_cl, 2, generator=g, device=device, dtype=torch.float64) * size
    kp = torch.where(taken[..., None], kp, torch.rand(kp.shape, generator=g, device=device,
                                                      dtype=torch.float64) * size)
    d = torch.where(taken[..., None], d, torch.randn(d.shape, generator=g, device=device))
    kp = torch.cat([kp, kp_cl], 1)
    d = torch.nn.functional.normalize(torch.cat([d, torch.randn(N, n_cl, dim, generator=g, device=device)], 1),
                                      dim=-1)
    lm = torch.cat([lm, torch.full((N, n_cl), -1, device=device, dtype=lm.dtype)], 1)
    perm = torch.argsort(torch.rand(N, K, generator=g, device=device), dim=1)
    kp = torch.gather(kp, 1, perm[..., None].expand(-1, -1, 2))
    d = torch.gather(d, 1, perm[..., None].expand(-1, -1, dim))
    lm = torch.gather(lm, 1, perm)
    return KnownFeatures(uv=kp.float().cpu().numpy(), descriptor=d.float().cpu().numpy(),
                         landmark=lm.cpu().numpy(), landmarks=X.cpu().numpy())
