"""Synthetic aerial-survey loader: N-camera serpentine capture of a textured
terrain, rendered on demand with exact GT poses.

Fills the role of the reference's large CI benchmark scenes
(.github/workflows/benchmark.yml:12-28 — palace-fine-arts-281,
gerrard-hall-100, south-building-128) in an environment where only the
12-image door is mounted: a deterministic >=100-image sequential scene that
exercises retrieval windows, the full SIFT front-end, cycle filtering,
averaging, and the camera-banded BA path at scale, with ground truth for
pose-error evaluation.

Geometry: cameras at altitude above a smooth random height-field
z = h(x, y), looking near-nadir with small random tilts, following a
serpentine (boustrophedon) survey path with ~75% along-track overlap.
Rendering is exact ray casting: for each pixel the ray/terrain intersection
is found by fixed-point iteration (terrain slope << 1 guarantees
contraction), then a smooth random albedo texture is sampled. Everything is
seeded — two loaders with the same parameters produce identical datasets.
"""

from __future__ import annotations

import numpy as np

from gtsfm_tpu_torch.common.image import Image
from gtsfm_tpu_torch.loader.base import LoaderBase


class SyntheticAerialLoader(LoaderBase):
    def __init__(
        self,
        num_images: int = 200,
        height: int = 384,
        width: int = 512,
        rows: int = 8,
        altitude: float = 10.0,
        terrain_relief: float = 3.5,  # ~35% of altitude: enough parallax that
        # pairs never approach the planar-scene E-matrix degeneracy (a flat
        # nadir survey is homography-ambiguous and breaks two-view geometry)
        # ~68 deg HFOV: wide-angle survey optics; narrow FOV + low relief is
        # the bas-relief-ambiguous regime where two-view E decomposition and
        # global BA both go soft.
        focal: float = 380.0,
        seed: int = 0,
        max_resolution: int = 760,
    ):
        super().__init__(max_resolution=max_resolution)
        self._n = int(num_images)
        self._h, self._w = int(height), int(width)
        self._f = float(focal)
        rng = np.random.default_rng(seed)

        # Serpentine path with survey-style overlap: ~75% along-track
        # (0.25-footprint spacing) and ~50% sidelap (0.5-footprint row
        # spacing) so the pair graph is CONNECTED across rows. Footprint
        # ~ altitude * width / focal.
        cols = (self._n + rows - 1) // rows
        foot = altitude * self._w / self._f
        x_span = (cols - 1) * foot * 0.25
        y_span = (rows - 1) * foot * 0.5
        self._world_size = max(x_span, y_span) + 2.0 * foot
        xs = foot + np.linspace(0.0, x_span, cols)
        ys = foot + np.linspace(0.0, y_span, max(rows, 1)) if rows > 1 else np.asarray([foot])
        centers, rots = [], []
        for r in range(rows):
            order = xs if r % 2 == 0 else xs[::-1]
            for x in order:
                if len(centers) >= self._n:
                    break
                c = np.asarray(
                    [x, ys[r], altitude + rng.normal() * 0.8], np.float32
                )
                # Near-nadir: camera +z looks DOWN (world -z) with a modest
                # tilt (oblique-survey style; adds rotation signal for the
                # averaging stages and further separates E from H).
                ax = rng.normal(size=3) * 0.12
                Rt = _small_rotation(ax) @ np.diag([1.0, -1.0, -1.0]).astype(np.float32)
                centers.append(c)
                rots.append(Rt.astype(np.float32))
        self._wti = np.stack(centers)
        self._wRi = np.stack(rots)
        self._foot = foot

        # Terrain: two-octave aperiodic value noise with feature size pinned
        # to the CAMERA FOOTPRINT, not to world_size. If terrain features
        # scale with the survey area (earlier design: smoothed grid over
        # [0, world_size]^2), a large-enough image count makes the terrain
        # locally planar within any one pair's overlap region — every pair
        # then sits in the planar E-matrix degeneracy and two-view poses
        # collapse scene-wide even though the matches are pixel-perfect.
        # Amplitude is slope-capped (~0.5) so the ray-marching fixed point
        # stays contractive for every pixel ray.
        self._terrain_cell = foot
        self._terrain_amp = min(terrain_relief, 0.26 * foot)
        self._terrain_salt = int(rng.integers(1, 2**31))

        # Multi-octave albedo texture from hash-lattice value noise: octave k
        # blends hashed lattice values at frequency base*2^k. Crucially the
        # lattice hash is aperiodic over the whole survey area — a wrap-tiled
        # texture (earlier design) repeats every world_size/2^k units, and
        # SIFT then matches DIFFERENT repeats of the same pattern between
        # distant images: those false matches are mutually consistent (a
        # translated copy of the texture), so RANSAC finds a confident wrong
        # model and the pair graph fills with poisoned edges. The octave
        # count is chosen so the finest octave has ~3 px features at the
        # render resolution — keypoint density then stays constant as the
        # survey area grows with the image count.
        px_world = altitude / self._f  # world units per pixel at nadir
        self._tex_base_freq = 1.0 / foot  # octave-0 feature = one footprint
        feat_world_base = 1.0 / self._tex_base_freq  # octave-0 feature size
        self._tex_n_oct = max(
            2,
            int(np.ceil(np.log2(max(feat_world_base / (3.0 * px_world), 2.0)))) + 1,
        )
        self._tex_salt = int(rng.integers(1, 2**31))
        self._cache: dict[int, Image] = {}

    # ------------------------------------------------------------ LoaderBase

    def __len__(self) -> int:
        return self._n

    def get_camera_intrinsics_full_res(self, index: int) -> np.ndarray:
        return np.asarray(
            [self._f, 0.0, 0.0, self._w / 2.0, self._h / 2.0], np.float32
        )

    def get_camera_pose(self, index: int):
        return self._wRi[index], self._wti[index]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        """Footprint-overlap pair gating (GPS-guided survey pairing; the
        reference's structured analog is HiltiLoader.is_valid_pair /
        SEQUENTIAL_HILTI — loader-driven pair selection where plain index
        windows miss the real adjacency). A serpentine survey's cross-row
        (sidelap) neighbors sit ~row-length apart in INDEX but one
        half-footprint apart on the ground: an index-lookahead window alone
        leaves the pair graph row-fragmented."""
        if not super().is_valid_pair(idx1, idx2):
            return False
        if abs(idx2 - idx1) <= 3:  # along-track neighbors (>=25% overlap)
            return True
        d = float(np.linalg.norm(self._wti[idx1][:2] - self._wti[idx2][:2]))
        return d <= 0.9 * self._foot

    def _height(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Terrain height: three-octave aperiodic value noise pinned to the
        camera footprint, zero-centered, slope-capped amplitude.

        The finest octave (quarter-footprint cells) is what defeats the
        planar-scene E-matrix degeneracy: with only footprint-scale features
        a single pair's overlap strip sees one smooth bump — locally a
        quadric ~ plane — and RANSAC accepts a whole family of wrong
        essential matrices with near-full inlier support."""
        c = self._terrain_cell
        s = self._terrain_salt
        v = (
            0.55 * _value_noise(x / c, y / c, s)
            + 0.25 * _value_noise(2.0 * x / c, 2.0 * y / c, s + 7)
            + 0.20 * _value_noise(4.0 * x / c, 4.0 * y / c, s + 13)
        )
        return (v - 0.5) * self._terrain_amp

    def get_image_full_res(self, index: int) -> Image:
        if index in self._cache:
            return self._cache[index]
        H, W, f = self._h, self._w, self._f
        R = self._wRi[index]
        c = self._wti[index]
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        d_cam = np.stack(
            [(xs - W / 2.0) / f, (ys - H / 2.0) / f, np.ones_like(xs, np.float64)], -1
        )
        d_world = d_cam @ R.T  # (H, W, 3), z-component negative (downward)
        dz = d_world[..., 2]
        # Fixed-point iteration on the ray/terrain intersection: t s.t.
        # c_z + t dz = h(c_xy + t d_xy). Contraction because |grad h| << |dz|.
        t = (0.0 - c[2]) / dz
        for _ in range(12):
            px = c[0] + t * d_world[..., 0]
            py = c[1] + t * d_world[..., 1]
            hh = self._height(px, py)
            t = (hh - c[2]) / dz
        px = c[0] + t * d_world[..., 0]
        py = c[1] + t * d_world[..., 1]
        albedo = np.zeros_like(px, dtype=np.float32)
        for k in range(self._tex_n_oct):
            freq = self._tex_base_freq * (2.0**k)
            albedo += 0.9**k * _value_noise(px * freq, py * freq,
                                            self._tex_salt + k)
        # Contrast-normalize the octave mix: averaging independent fields
        # shrinks the dynamic range and SIFT's contrast threshold would
        # reject everything.
        albedo = (albedo - albedo.mean()) / max(float(albedo.std()), 1e-6)
        albedo = np.clip(albedo * 0.22 + 0.55, 0.0, 1.0)
        # Mild shading from height (adds low-frequency structure).
        shade = 0.75 + 0.25 * (
            self._height(px, py) / max(self._terrain_amp, 1e-9) + 0.5
        )
        img8 = np.clip(albedo * shade * 255.0, 0, 255).astype(np.uint8)
        img = Image(value_array=img8)
        self._cache[index] = img
        return img


def _hash01(ix: np.ndarray, iy: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic aperiodic hash of integer lattice coords -> [0, 1)."""
    h = (ix * np.int64(73856093)) ^ (iy * np.int64(19349663)) ^ np.int64(salt)
    h = (h ^ (h >> 13)) * np.int64(0x5BD1E995)
    h = h ^ (h >> 15)
    return ((h & np.int64(0xFFFFFF)).astype(np.float32)) / np.float32(0x1000000)


def _value_noise(x: np.ndarray, y: np.ndarray, salt: int) -> np.ndarray:
    """Smooth aperiodic value noise: hashed lattice + smoothstep bilinear."""
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    fx = fx * fx * (3.0 - 2.0 * fx)  # smoothstep: C1 across cell borders
    fy = fy * fy * (3.0 - 2.0 * fy)
    ix = x0.astype(np.int64)
    iy = y0.astype(np.int64)
    v00 = _hash01(ix, iy, salt)
    v10 = _hash01(ix + 1, iy, salt)
    v01 = _hash01(ix, iy + 1, salt)
    v11 = _hash01(ix + 1, iy + 1, salt)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v10 * fx * (1 - fy)
        + v01 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _small_rotation(axis_angle: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(axis_angle))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = axis_angle / theta
    Kx = np.asarray(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return (np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx).astype(
        np.float32
    )
