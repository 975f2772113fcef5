"""Mesh ray-cast ground-truth correspondence classification.

Port of gtsfm_tpu/evaluation/mesh_metrics.py (reference gtsfm/utils/metrics.py:131,
mesh_inlier_correspondences + compute_keypoint_intersections), used for
astrovision scenes where a GT surface mesh exists and epipolar checks are
weak at low parallax. A ray per keypoint is backprojected through its GT
camera, cast against the mesh with a batched Möller–Trumbore over (ray,
face) pairs, and the first hit is projected through the other GT camera.

The faces are cut into tiles of ``face_chunk`` (padded with index-0
degenerate triangles, which the parallel test rejects), as the JAX
package's lax.scan does, and each ray keeps a running minimum of t, so peak
memory is O(rays x face_chunk) whatever the mesh size. Two things are the
port's own and change no hit:
  * the faces are ordered along a Morton curve of their centroids before
    tiling, so a tile is a compact patch of the surface, and each ray is
    tested only against the tiles whose bounding box (grown by 1e-3 of the
    mesh extent and of the tile's longest edge) its forward half-line
    crosses. The first hit is a minimum over faces, so neither the order
    nor skipping a face that the ray cannot meet changes it; only a
    grazing face (|a| near ``eps``), whose rounding can put a "hit" far
    outside the triangle, could have differed;
  * rays are cast in blocks of at most ``BLOCK_ELEMS`` (ray, face) tests,
    so ``mesh_inlier_correspondences_batched`` casts every pair's rays in
    one pass over the faces with bounded memory, whatever the ray count,
    and a ray that several pairs share (a keypoint verified in each) once.
Each (ray, face) test runs the same elementwise float32 arithmetic in
every path, so a pair's numbers do not depend on which rays share its
block.

Also provides the minimal PLY mesh reader the astrovision fixtures need
(binary little-endian or ascii, xyz[+extras] vertices, uchar-count int
faces) — the reference gets this from trimesh.load.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import cameras

# Most (ray, face) tests in one block: about 16 float32 tensors of this many
# elements are live at once, so 2**26 keeps a block near 4.3 GB.
BLOCK_ELEMS = 1 << 26
# Margin of the tiles' bounding boxes: of the mesh extent, and of the
# tile's longest edge (the barycentric tolerance 1e-4 lets a hit lie that
# far outside its triangle).
_BOX_MARGIN = 1e-3
_B_EPS = 1e-4

_SIZES = {"char": "b", "uchar": "B", "int8": "b", "uint8": "B",
          "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
          "int": "i", "uint": "I", "int32": "i", "uint32": "I",
          "float": "f", "float32": "f", "double": "d", "float64": "d"}


def read_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a triangle mesh from a PLY file -> (vertices (V,3) f32, faces (F,3) i32).

    Supports format ascii / binary_little_endian, float32 x/y/z leading
    vertex properties (extra scalar vertex properties are skipped), and
    faces as a (uchar count, int32 indices) list. Non-triangle faces are
    fan-triangulated. A binary face block of triangles only is read in one
    numpy view; other blocks face by face.
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", f"{parts[2]}:{parts[3]}"))
            else:
                elements[-1][2].append((parts[1], parts[2]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    verts: np.ndarray | None = None
    faces: list[list[int]] = []
    triangles: np.ndarray | None = None  # set when every face is a triangle
    if fmt == "ascii":
        tokens = body.decode("ascii").split("\n")
        ti = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                while ti < len(tokens) and not tokens[ti].strip():
                    ti += 1
                row = tokens[ti].split()
                ti += 1
                rows.append(row)
            if name == "vertex":
                verts = np.asarray([[float(r[k]) for k in range(3)] for r in rows], np.float32)
            elif name == "face":
                for r in rows:
                    n = int(r[0])
                    faces.append([int(x) for x in r[1:1 + n]])
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_row = "<" + "".join(_SIZES[t] for t, _ in props)
                row_sz = struct.calcsize(fmt_row)
                arr = np.frombuffer(body, dtype=np.uint8, count=count * row_sz, offset=off)
                arr = arr.reshape(count, row_sz)
                # x, y, z are the leading three properties by convention
                if [n for _, n in props[:3]] != ["x", "y", "z"]:
                    raise ValueError(f"{path}: vertex properties {props} do not start with x, y, z")
                xyz_fmt = "<" + "".join(_SIZES[t] for t, _ in props[:3])
                xyz_sz = struct.calcsize(xyz_fmt)
                verts = np.frombuffer(arr[:, :xyz_sz].tobytes(), dtype="<f4").reshape(count, 3).astype(np.float32)
                off += count * row_sz
            elif name == "face":
                (ltype,) = [p for t, p in props if t == "list"][:1] or [None]
                cnt_t, idx_t = ltype.split(":")
                cnt_sz = struct.calcsize(_SIZES[cnt_t])
                idx_sz = struct.calcsize(_SIZES[idx_t])
                tri_row = cnt_sz + 3 * idx_sz
                if count and off + count * tri_row <= len(body):
                    rec = np.frombuffer(body, dtype=np.dtype([("n", "<" + _SIZES[cnt_t]),
                                                              ("i", "<" + _SIZES[idx_t], (3,))]),
                                        count=count, offset=off)
                    # If every count reads 3, the rows really are laid out
                    # back to back at this stride (each row starts where the
                    # previous triangle ended).
                    if np.all(rec["n"] == 3):
                        triangles = rec["i"]
                        off += count * tri_row
                        continue
                for _ in range(count):
                    (n,) = struct.unpack_from("<" + _SIZES[cnt_t], body, off)
                    off += cnt_sz
                    idxs = struct.unpack_from("<" + _SIZES[idx_t] * n, body, off)
                    off += idx_sz * n
                    faces.append(list(idxs))
            else:  # skip unknown fixed-size element
                fmt_row = "<" + "".join(_SIZES[t] for t, _ in props)
                off += count * struct.calcsize(fmt_row)
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    if triangles is not None:
        return verts, triangles.astype(np.int32)
    if faces and all(len(fc) == 3 for fc in faces):
        return verts, np.asarray(faces, np.int32)
    tris = []
    for fc in faces:
        for k in range(1, len(fc) - 1):  # fan triangulation
            tris.append((fc[0], fc[k], fc[k + 1]))
    return verts, np.asarray(tris, np.int32)


class MeshTiles(NamedTuple):
    """A mesh on the device, cut into face tiles for casting.

    v0, e1, e2: (T, Fc, 3) float32 — each face's first vertex and its edges
    v1 - v0, v2 - v0 (padding faces: v0 = vertex 0, zero edges);
    lo, hi: (T, 3) float32 bounding box of each tile's real faces, grown
    by the margin; num_faces: the real face count."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    num_faces: int


def _morton_order(tri: np.ndarray) -> np.ndarray:
    """Face order along a 3D Morton curve of the centroids (float64 on the
    host, so every device tiles the same way). One scale for the three axes:
    a flat surface (a terrain) spends no bits on its thin axis, so a tile is
    a compact patch of it."""
    c = tri.astype(np.float64).mean(axis=1)
    lo = c.min(axis=0)
    q = np.floor((c - lo) / max(float(np.max(c.max(axis=0) - lo)), 1e-300) * 1023.0).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")


def mesh_tiles(vertices, faces, face_chunk: int = 8192, device: str | torch.device = "cuda") -> MeshTiles:
    """Tiles of ``face_chunk`` faces (one tile of all faces if F <= face_chunk)
    with their bounding boxes, on ``device``. Build once per mesh and cast
    any number of rays against it with :func:`first_hit_t`."""
    verts = np.asarray(vertices.cpu() if isinstance(vertices, torch.Tensor) else vertices, np.float32)
    fcs = np.asarray(faces.cpu() if isinstance(faces, torch.Tensor) else faces).astype(np.int64)
    F = fcs.shape[0]
    if F == 0:
        raise ValueError("the mesh has no faces")
    fcs = fcs[_morton_order(verts[fcs])]
    chunk = F if F <= face_chunk else face_chunk
    T = -(-F // chunk)
    pad = T * chunk - F
    # Index-0 padding makes degenerate (v0,v0,v0) triangles: zero edge
    # vectors -> |a| < eps -> rejected as parallel, never a hit.
    fcs_p = np.concatenate([fcs, np.zeros((pad, 3), np.int64)], axis=0).reshape(T, chunk, 3)
    real = (np.arange(T * chunk) < F).reshape(T, chunk)

    v = torch.as_tensor(verts, device=device)
    idx = torch.as_tensor(fcs_p, device=device)
    v0 = v[idx[..., 0]]
    e1 = v[idx[..., 1]] - v0
    e2 = v[idx[..., 2]] - v0
    tri = torch.as_tensor(verts[fcs_p].astype(np.float64), device=device)  # (T, Fc, 3 corners, 3)
    live = torch.as_tensor(real, device=device)[..., None, None]
    lo = torch.where(live, tri, torch.inf).amin(dim=(1, 2))
    hi = torch.where(live, tri, -torch.inf).amax(dim=(1, 2))
    extent = float(np.linalg.norm(verts.max(axis=0) - verts.min(axis=0)))
    edge = torch.linalg.vector_norm(tri - torch.roll(tri, 1, dims=2), dim=-1)
    longest = torch.where(live[..., 0], edge, 0.0).amax(dim=(1, 2))
    margin = (_BOX_MARGIN * (extent + longest))[:, None]
    return MeshTiles(v0=v0, e1=e1, e2=e2, lo=(lo - margin).float(), hi=(hi + margin).float(), num_faces=F)


def _min_hit_t(origins, dirs, v0, e1, e2, eps: float) -> torch.Tensor:
    """Min valid Möller–Trumbore t per ray over one face tile -> (N,), inf
    if none. Rays (N, 3) against faces (Fc, 3), component by component:
    the cross products are jnp.cross's formulas, the dot products sum
    x, y, z in that order."""
    dx, dy, dz = (dirs[:, k, None] for k in range(3))
    ax, ay, az = (e1[None, :, k] for k in range(3))
    bx, by, bz = (e2[None, :, k] for k in range(3))
    # h = d x e2
    hx = dy * bz - dz * by
    hy = dz * bx - dx * bz
    hz = dx * by - dy * bx
    a = ax * hx + ay * hy + az * hz
    parallel = torch.abs(a) < eps
    f = 1.0 / torch.where(parallel, 1.0, a)
    del a
    sx, sy, sz = (origins[:, k, None] - v0[None, :, k] for k in range(3))
    u = f * (sx * hx + sy * hy + sz * hz)
    del hx, hy, hz
    # q = s x e1
    qx = sy * az - sz * ay
    qy = sz * ax - sx * az
    qz = sx * ay - sy * ax
    del sx, sy, sz
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (bx * qx + by * qy + bz * qz)
    del qx, qy, qz, f
    # Barycentric tolerance: rays through a shared edge/vertex land exactly
    # on the u/v bounds, where f32 rounding would otherwise drop the hit on
    # EVERY adjacent face at once.
    valid = (~parallel) & (u >= -_B_EPS) & (u <= 1.0 + _B_EPS) & (v >= -_B_EPS) & (u + v <= 1.0 + _B_EPS) & (t > eps)
    return torch.amin(torch.where(valid, t, torch.inf), dim=1)


def _min_hit_t_for_faces(origins, dirs, vertices, faces, eps: float) -> torch.Tensor:
    """Min valid Möller–Trumbore t per ray over ONE face tile -> (N,), inf if none."""
    faces = faces.long()
    v0 = vertices[faces[:, 0]]
    return _min_hit_t(origins, dirs, v0, vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0, eps)


def _rays_meet_boxes(origins, dirs, lo, hi) -> torch.Tensor:
    """(N, T) bool: the forward half-line of each ray crosses each box
    (slab test; an axis the ray does not move along needs the origin
    inside that slab)."""
    o, d = origins[:, None, :], dirs[:, None, :]
    ta = (lo[None] - o) / d
    tb = (hi[None] - o) / d
    flat = d == 0
    inside = (lo[None] <= o) & (o <= hi[None])
    t_near = torch.where(flat, torch.where(inside, -torch.inf, torch.inf), torch.minimum(ta, tb)).amax(dim=-1)
    t_far = torch.where(flat, torch.where(inside, torch.inf, -torch.inf), torch.maximum(ta, tb)).amin(dim=-1)
    return t_far >= torch.clamp(t_near, min=0.0)


def first_hit_t(origins, dirs, tiles: MeshTiles, eps: float = 1e-7) -> tuple[torch.Tensor, int]:
    """Smallest valid t per ray over every face -> ((N,) float32, inf where
    the ray misses, and the count of (ray, face) tests run). Each tile is
    tested only by the rays that cross its box, in blocks of at most
    BLOCK_ELEMS tests."""
    N = origins.shape[0]
    T, Fc = tiles.v0.shape[:2]
    t_min = torch.full((N,), torch.inf, dtype=origins.dtype, device=origins.device)
    if N == 0:
        return t_min, 0
    rows = max(1, BLOCK_ELEMS // (T * 3))
    meets = torch.cat([_rays_meet_boxes(origins[i:i + rows], dirs[i:i + rows], tiles.lo, tiles.hi)
                       for i in range(0, N, rows)])
    tile_of, ray_of = torch.nonzero(meets.T, as_tuple=True)  # sorted by tile, then ray
    counts = torch.bincount(tile_of, minlength=T).tolist()
    block = max(1, BLOCK_ELEMS // Fc)
    start = 0
    for j, c in enumerate(counts):
        for b in range(start, start + c, block):
            sel = ray_of[b:min(b + block, start + c)]
            t_c = _min_hit_t(origins[sel], dirs[sel], tiles.v0[j], tiles.e1[j], tiles.e2[j], eps)
            t_min[sel] = torch.minimum(t_min[sel], t_c)
        start += c
    return t_min, start * Fc


def ray_mesh_first_hit(
    origins: torch.Tensor,  # (N, 3)
    dirs: torch.Tensor,  # (N, 3) need not be normalized
    vertices,  # (V, 3)
    faces,  # (F, 3) int
    eps: float = 1e-7,
    face_chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Möller–Trumbore: first (min-t, t>eps) intersection per ray.

    The faces are cut into ``face_chunk`` tiles with a running min-t, so
    peak memory is O(N * face_chunk) regardless of mesh size.

    Returns (hit (N,) bool, points (N, 3); garbage where no hit).
    """
    t_min, _ = first_hit_t(origins, dirs, mesh_tiles(vertices, faces, face_chunk, origins.device), eps)
    hit = torch.isfinite(t_min)
    pts = origins + torch.where(hit, t_min, 0.0)[:, None] * dirs
    return hit, pts


def backproject_rays(uv, cal, wRi, wti) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel keypoints -> world-frame rays (origins (N,3), dirs (N,3)).
    wRi @ [x, y, 1] is summed column by column, so a (3, 3) rotation and
    one (N, 3, 3) rotation per ray round alike."""
    pn = cameras.bundler_calibrate(cal[None] if cal.dim() == 1 else cal, uv)  # (N, 2) normalized
    d_world = pn[:, 0:1] * wRi[..., :, 0] + pn[:, 1:2] * wRi[..., :, 1] + wRi[..., :, 2]
    origins = torch.broadcast_to(wti, d_world.shape)
    return origins, d_world


def _project(wRi, wti, cal, X) -> tuple[torch.Tensor, torch.Tensor]:
    """cameras.project_bundler's Cal3Bundler projection, summed component
    by component: one camera ((3, 3), (3,), (5,)) or one per point
    ((N, 3, 3), (N, 3), (N, 5)) round alike."""
    d = X - wti
    pc = d[:, 0:1] * wRi[..., 0, :] + d[:, 1:2] * wRi[..., 1, :] + d[:, 2:3] * wRi[..., 2, :]  # wRi^T (X - wti)
    depth = pc[:, 2]
    safe_z = torch.where(torch.abs(depth) < 1e-9, 1e-9, depth)
    p = pc[:, :2] / safe_z[:, None]
    r2 = torch.sum(p * p, dim=-1)
    g = 1.0 + cal[..., 1] * r2 + cal[..., 2] * r2 * r2
    return (cal[..., 0] * g)[:, None] * p + cal[..., 3:5], depth


def _classify(uv1, uv2, cal1, cal2, wRi1, wti1, wRi2, wti2, hit1, X1, hit2, X2, dist_threshold: float):
    """Reference semantics on the hits of both rays of each correspondence;
    the cameras are one per side ((3, 3), (3,), (5,)) or one per
    correspondence (leading N)."""
    both = hit1 & hit2
    # Forward-project each hit through the OTHER camera.
    uv_12, z12 = _project(wRi2, wti2, cal2, X1)
    uv_21, z21 = _project(wRi1, wti1, cal1, X2)
    ok = both & (z12 > 0) & (z21 > 0)
    err12 = torch.linalg.vector_norm(uv_12 - uv2, dim=-1)
    err21 = torch.linalg.vector_norm(uv_21 - uv1, dim=-1)
    err = torch.maximum(err12, err21)
    is_inlier = ok & (err < dist_threshold)
    nan = torch.full_like(err, torch.nan)
    reproj = torch.where(both, torch.where(ok, err, nan), nan)
    return is_inlier, reproj


def mesh_inlier_correspondences(
    uv1: torch.Tensor,  # (N, 2) matched keypoints in image 1
    uv2: torch.Tensor,  # (N, 2) corresponding keypoints in image 2
    cal1: torch.Tensor,  # (5,) Cal3Bundler
    cal2: torch.Tensor,
    wRi1: torch.Tensor, wti1: torch.Tensor,  # GT camera 1 (cam-to-world)
    wRi2: torch.Tensor, wti2: torch.Tensor,
    vertices, faces,
    dist_threshold: float = 4.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Classify correspondences via GT mesh ray-casting.

    Reference semantics (utils/metrics.py:131): a correspondence is inlier
    iff BOTH keypoint rays hit the mesh, both hits project in front of the
    other camera, and the max symmetric reprojection error < threshold.
    Returns (is_inlier (N,) bool, reproj_err (N,) — NaN where unclassified).
    """
    o1, d1 = backproject_rays(uv1, cal1, wRi1, wti1)
    o2, d2 = backproject_rays(uv2, cal2, wRi2, wti2)
    hit1, X1 = ray_mesh_first_hit(o1, d1, vertices, faces)
    hit2, X2 = ray_mesh_first_hit(o2, d2, vertices, faces)
    return _classify(uv1, uv2, cal1, cal2, wRi1, wti1, wRi2, wti2, hit1, X1, hit2, X2, dist_threshold)


def mesh_inlier_correspondences_batched(
    pairs,  # list of (uv1, uv2, cal1, cal2, wRi1, wti1, wRi2, wti2), tensors on one device
    vertices, faces,
    dist_threshold: float = 4.0,
    eps: float = 1e-7,
    face_chunk: int = 8192,
) -> tuple[list[tuple[torch.Tensor, torch.Tensor]], dict]:
    """:func:`mesh_inlier_correspondences` for many pairs at once: the mesh
    goes to the device once, every pair's correspondences are backprojected
    and classified together with one camera row per correspondence, the
    distinct rays (both sides) are cast in one pass over the mesh's tiles,
    and the results are split back per pair. Each pair's (is_inlier,
    reproj_err) equals the per-pair call's, bit for bit: every step is
    elementwise and rounds a broadcast camera as a gathered one.

    Returns (one (is_inlier, reproj_err) per pair, {"rays" (both sides of
    every pair), "rays_cast" (the distinct ones), "faces",
    "ray_triangle_tests"})."""
    if not pairs:
        return [], {"rays": 0, "rays_cast": 0, "faces": len(faces), "ray_triangle_tests": 0}
    sizes = [p[0].shape[0] for p in pairs]

    def per_corr(k):  # field k of every pair (uv, or a camera repeated), one row per correspondence
        return torch.cat([p[k] if k < 2 else p[k].expand(n, *p[k].shape) for p, n in zip(pairs, sizes)])

    uv1, uv2, cal1, cal2, R1, t1, R2, t2 = (per_corr(k) for k in range(8))
    o1, d1 = backproject_rays(uv1, cal1, R1, t1)
    o2, d2 = backproject_rays(uv2, cal2, R2, t2)
    origins, dirs = torch.cat([o1, o2]), torch.cat([d1, d2])
    # A keypoint verified in several pairs gives the same ray, bit for bit:
    # each distinct ray is cast once.
    uniq, inverse = torch.unique(torch.cat([origins, dirs], dim=1), dim=0, return_inverse=True)
    tiles = mesh_tiles(vertices, faces, face_chunk, origins.device)
    t_uniq, tests = first_hit_t(uniq[:, :3].contiguous(), uniq[:, 3:].contiguous(), tiles, eps)
    t_min = t_uniq[inverse]
    hit = torch.isfinite(t_min)
    pts = origins + torch.where(hit, t_min, 0.0)[:, None] * dirs
    M = uv1.shape[0]
    is_inlier, reproj = _classify(uv1, uv2, cal1, cal2, R1, t1, R2, t2, hit[:M], pts[:M], hit[M:], pts[M:],
                                  dist_threshold)
    out = list(zip(is_inlier.split(sizes), reproj.split(sizes)))
    return out, {"rays": 2 * M, "rays_cast": int(uniq.shape[0]), "faces": tiles.num_faces,
                 "ray_triangle_tests": tests}
