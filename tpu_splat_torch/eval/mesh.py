"""Mesh extraction (port of tpu_splat/eval/mesh.py; role of reference
utils/mesh_utils.py GaussianExtractor + utils/mcube_utils.py).

- GaussianExtractor: render every view with the full render(), keeping the
  colour, alpha, surf_depth and normal maps on the device.
- tsdf_fusion: fuse the depth maps into a voxel TSDF and colour grid
  (camera-projective, truncation and weight averaging) in z-chunks, as
  tensor ops on the maps' device.
- marching_tetrahedra: triangulate the zero level of an SDF grid over the
  6-tetrahedra cube decomposition, on the grid's device.
- save_mesh_ply: binary little-endian PLY triangle mesh writer.

The arithmetic follows the JAX package's numpy step for step: the fusion
geometry in float64 (the float32 depth is promoted in `d - z`), pixels
rounded half to even, the projections written out as sums of products in
the order of the 4-term dot, a masked update per view (a voxel appears at
most once per view, so it equals numpy's fancy-index update). Marching
keeps numpy's emission order (x-slabs of the same size, then the tets in
order, then their two triangles), welds with a lexicographic unique of the
rounded keys where the last emitted duplicate gives the position (numpy's
fancy assignment), and orients the faces by the same central-difference
gradient. The same grid then gives the same mesh on the card, on the CPU
and in the JAX package.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

# 6-tetra decomposition of a unit cube: corner ids are bit-packed (x|y<<1|z<<2)
# Every tet shares the main diagonal 0-7, guaranteeing a crack-free mesh.
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int64,
)
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)
# tet edge list (pairs of local tet-vertex ids 0..3)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64
)
# For each of the 16 inside-masks of a tet's 4 vertices: triangles as triples
# of tet-edge ids (-1 = unused). Derived from the 3 canonical cases:
# one vertex inside (1 tri), two inside (2 tris / quad), complements mirrored.
_TET_TRIS = -np.ones((16, 2, 3), np.int64)


def _init_tet_table():
    # single-vertex cases: vertex v inside -> tri over its 3 incident edges
    incident = {
        0: [0, 1, 2],  # edges touching vertex 0
        1: [0, 3, 4],
        2: [1, 3, 5],
        3: [2, 4, 5],
    }
    # consistent winding chosen per case; orientation is fixed afterwards by
    # pointing normals along the SDF gradient (see marching_tetrahedra).
    for v, (a, b, c) in incident.items():
        _TET_TRIS[1 << v, 0] = (a, b, c)
        _TET_TRIS[0b1111 ^ (1 << v), 0] = (a, c, b)
    # two-vertex cases: quad between the 4 edges crossing the cut
    quads = {
        0b0011: (1, 2, 4, 3),  # verts {0,1} in: edges 0-2,0-3,1-3,1-2
        0b0101: (0, 2, 5, 3),  # verts {0,2}
        0b1001: (0, 1, 5, 4),  # verts {0,3}
        0b0110: (0, 4, 5, 1),  # verts {1,2}
        0b1010: (0, 3, 5, 2),  # verts {1,3}
        0b1100: (1, 3, 4, 2),  # verts {2,3}
    }
    for mask, (a, b, c, d) in quads.items():
        _TET_TRIS[mask, 0] = (a, b, c)
        _TET_TRIS[mask, 1] = (a, c, d)


_init_tet_table()


class Mesh(NamedTuple):
    vertices: np.ndarray  # [V,3] f32
    faces: np.ndarray  # [F,3] i32
    colors: np.ndarray | None = None  # [V,3] u8


def _as_tensor(x, device=None) -> torch.Tensor:
    """A tensor on `device`, or where it already lives (numpy: the CPU)."""
    t = torch.as_tensor(x)
    return t if device is None else t.to(device)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as a true division on every device: a Python number
    as divisor makes the CUDA kernel multiply by its reciprocal, one
    rounding more than numpy's divide."""
    return x / x.new_full((), c)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """np.cross over the last axis: each component one product minus
    another, rounded separately (no fused multiply-add)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _sweep_tets(corner_idx, vals, verts_out, faces_out, v_count):
    """Emit triangles for every tet of every (sign-changing) cell.
    corner_idx [C,8,3] grid coords, vals [C,8] SDF values."""
    dev = vals.device
    tet_tris = torch.as_tensor(_TET_TRIS, device=dev)
    e0 = torch.as_tensor(_TET_EDGES[:, 0], device=dev)
    e1 = torch.as_tensor(_TET_EDGES[:, 1], device=dev)
    one = torch.ones((), dtype=vals.dtype, device=dev)
    for tet in _TETS:
        tv = vals[:, torch.as_tensor(tet, device=dev)]  # [C,4]
        neg = (tv < 0).long()
        mask = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2) | (neg[:, 3] << 3)
        active = (mask != 0) & (mask != 0b1111)
        cells = torch.nonzero(active).squeeze(1)
        if cells.numel() == 0:
            continue
        tris = tet_tris[mask[cells]]  # [A,2,3] tet-edge ids
        tvc = tv[cells]  # [A,4]
        pos = corner_idx[cells][:, torch.as_tensor(tet, device=dev)]  # [A,4,3]

        # interpolated crossing point on each of the 6 tet edges [A,6,3]
        va, vb = tvc[:, e0], tvc[:, e1]  # [A,6]
        denom = vb - va
        t = torch.where(denom.abs() > 1e-12, -va / torch.where(denom == 0, one, denom),
                        0.5 * one)
        t = torch.clamp(t, 0.0, 1.0)
        pa, pb = pos[:, e0].double(), pos[:, e1].double()
        cross = pa + t[..., None].double() * (pb - pa)  # [A,6,3]

        for k in range(2):
            tk = tris[:, k]  # [A,3]
            idx = torch.nonzero(tk[:, 0] >= 0).squeeze(1)
            B = idx.numel()
            if B == 0:
                continue
            tri_pts = cross[idx[:, None], tk[idx]]  # [B,3,3]
            verts_out.append(tri_pts.reshape(-1, 3))
            faces_out.append(
                torch.arange(v_count, v_count + 3 * B, dtype=torch.int64, device=dev
                             ).reshape(B, 3)
            )
            v_count += 3 * B
    return v_count


def marching_tetrahedra(sdf, level: float = 0.0, origin=(0.0, 0.0, 0.0),
                        spacing: float = 1.0) -> Mesh:
    """Triangulate the `level` isosurface of sdf [Nx,Ny,Nz] (inside = sdf <
    level), a tensor (on its device) or a numpy array (on the CPU). Returns
    world-space vertices origin + spacing*grid_coord, with triangles wound so
    normals point toward increasing SDF (outside), as numpy arrays."""
    f = _as_tensor(sdf) - level
    dev = f.device
    nx, ny, nz = f.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    offsets = torch.as_tensor(_CORNER_OFFSETS, device=dev)

    verts_out, faces_out = [], []
    v_count = 0
    # x-slabs of the JAX package's size: the emission order (and so which
    # duplicate gives a welded vertex its position) follows the slabs
    x_chunk = max(1, (1 << 22) // max(cy * cz, 1))
    for x0 in range(0, cx, x_chunk):
        x1 = min(x0 + x_chunk, cx)
        base = torch.stack(
            torch.meshgrid(
                torch.arange(x0, x1, device=dev), torch.arange(cy, device=dev),
                torch.arange(cz, device=dev), indexing="ij"),
            dim=-1,
        ).reshape(-1, 3)  # [C,3]
        corner_idx = base[:, None, :] + offsets[None]  # [C,8,3]
        vals = f[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
        # only cells whose corner signs differ can emit geometry
        neg = vals < 0
        active_cells = neg.any(dim=1) & ~neg.all(dim=1)
        if not bool(active_cells.any()):
            continue
        v_count = _sweep_tets(corner_idx[active_cells], vals[active_cells], verts_out,
                              faces_out, v_count)
    if not verts_out:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    verts = torch.cat(verts_out)
    faces = torch.cat(faces_out)

    # weld duplicate vertices (crossings shared between tets/cells): rows
    # sorted lexicographically (np.unique(axis=0)); a welded vertex takes
    # the position of its last emitted duplicate, as numpy's `welded[inv] =
    # verts` leaves it
    key = torch.round(verts * 1e6).long()
    _, inv = torch.unique(key, dim=0, sorted=True, return_inverse=True)
    n_uniq = int(inv.max()) + 1
    last = torch.full((n_uniq,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, inv, torch.arange(len(inv), device=dev), "amax")
    welded = verts[last]
    faces = inv[faces]
    # drop degenerate faces
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # orient faces along the SDF gradient (outward normals); np.gradient's
    # central differences, one-sided at the border
    gx, gy, gz = torch.gradient(f, edge_order=1)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], device=dev)
    vi = torch.minimum(torch.clamp(torch.round(welded).long(), min=0), hi)
    grad = torch.stack([g[vi[:, 0], vi[:, 1], vi[:, 2]] for g in (gx, gy, gz)], dim=-1)
    tg = grad[faces]  # [F,3,3]
    tri_grad = _div(tg[:, 0] + tg[:, 1] + tg[:, 2], 3.0)  # numpy's mean of 3, in order
    e1v = welded[faces[:, 1]] - welded[faces[:, 0]]
    e2v = welded[faces[:, 2]] - welded[faces[:, 0]]
    n = _cross(e1v, e2v)
    p = n * tri_grad.double()
    flip = (p[:, 0] + p[:, 1] + p[:, 2]) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    origin = torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    world = origin[None] + welded * spacing
    return Mesh(world.float().cpu().numpy(), faces.int().cpu().numpy())


def _rows(M: torch.Tensor, x, y, z):
    """The first three rows of M applied to the column (x, y, z, 1) (M
    [4,4]) or (x, y, z) (M [3,3]), each row's dot summed left to right, as
    numpy's matmul of a homogeneous column."""
    out = []
    for r in range(3):
        acc = x * M[r, 0] + y * M[r, 1] + z * M[r, 2]
        out.append(acc + M[r, 3] if M.shape[1] == 4 else acc)
    return out


def tsdf_fusion(
    depths,  # [H,W] metric depth per view
    colors,  # [H,W,3] float in [0,1]
    alphas,  # [H,W] coverage
    Ks,  # [3,3] intrinsics
    w2cs,  # [4,4] world->camera
    bounds_min,
    bounds_max,
    resolution: int = 128,
    trunc: float | None = None,
    alpha_thres: float = 0.5,
    depth_trunc: float | None = None,
    z_chunk: int = 16,
):
    """Projective TSDF fusion (classic KinectFusion update), z-chunked to
    bound memory, on the device of the depth maps (numpy maps: the CPU).
    Returns (tsdf, color, weight, origin, spacing): the grids as tensors on
    that device, origin a float64 numpy array. A voxel's value depends only
    on the views, in order, not on the chunk it falls in, so `z_chunk` sets
    the memory and not the result."""
    dev = _as_tensor(depths[0]).device
    bounds_min = np.asarray(bounds_min, np.float64)
    bounds_max = np.asarray(bounds_max, np.float64)
    spacing = float((bounds_max - bounds_min).max()) / (resolution - 1)
    dims = np.maximum(
        np.ceil((bounds_max - bounds_min) / spacing).astype(int) + 1, 2
    )
    if trunc is None:
        trunc = 4.0 * spacing
    X, Y, Z = (int(d) for d in dims)

    tsdf = torch.ones((X, Y, Z), dtype=torch.float32, device=dev)
    weight = torch.zeros((X, Y, Z), dtype=torch.float32, device=dev)
    color = torch.zeros((X, Y, Z, 3), dtype=torch.float32, device=dev)
    tsdf_flat, w_flat, c_flat = tsdf.view(-1), weight.view(-1), color.view(-1, 3)

    axis = lambda k, n: torch.as_tensor(
        bounds_min[k] + spacing * np.arange(n), dtype=torch.float64, device=dev)
    xs, ys, zs = axis(0, X)[:, None, None], axis(1, Y)[None, :, None], axis(2, Z)
    views = [
        (_as_tensor(d, dev), _as_tensor(c, dev), _as_tensor(a, dev),
         _as_tensor(K, dev).double(), _as_tensor(w2c, dev).double())
        for d, c, a, K, w2c in zip(depths, colors, alphas, Ks, w2cs)
    ]
    lin = torch.arange(X * Y, device=dev).reshape(X, Y, 1) * Z

    for z0 in range(0, Z, z_chunk):
        z1 = min(z0 + z_chunk, Z)
        zc = zs[None, None, z0:z1]
        gidx_all = (lin + torch.arange(z0, z1, device=dev)).reshape(-1)
        for depth, col, alpha, K, w2c in views:
            H, W = depth.shape
            cam = [c.reshape(-1) for c in _rows(w2c, xs, ys, zc)]
            z = cam[2]
            front = z > 1e-6
            uvw = _rows(K, *cam)
            den = torch.clamp(uvw[2], min=1e-12)
            ur = torch.round(uvw[0] / den)
            vr = torch.round(uvw[1] / den)
            inside = front & (ur >= 0) & (ur < W) & (vr >= 0) & (vr < H)
            sel = torch.nonzero(inside).squeeze(1)
            if sel.numel() == 0:
                continue
            uif, vif = ur[sel].long(), vr[sel].long()
            d = depth[vif, uif]
            a = alpha[vif, uif]
            valid = (a > alpha_thres) & (d > 0)
            if depth_trunc is not None:
                valid &= d < depth_trunc
            sdf = d.double() - z[sel]
            upd = valid & (sdf > -trunc)
            tv = torch.clamp(_div(sdf, trunc), max=1.0)

            keep = torch.nonzero(upd).squeeze(1)
            gidx = gidx_all[sel[keep]]
            w_old = w_flat[gidx]
            w_new = w_old + 1.0
            # float32 products, the float64 value rounded once on the store
            tsdf_flat[gidx] = (((tsdf_flat[gidx] * w_old).double() + tv[keep])
                               / w_new.double()).float()
            c_flat[gidx] = ((c_flat[gidx] * w_old[:, None] + col[vif[keep], uif[keep]])
                            / w_new[:, None]).float()
            w_flat[gidx] = w_new

    return tsdf, color, weight, bounds_min, spacing


def vertex_colors(mesh: Mesh, color: torch.Tensor, origin, spacing: float) -> np.ndarray:
    """Each vertex's colour from the nearest voxel of the colour grid
    [X,Y,Z,3], as uint8 (truncated, as numpy's astype)."""
    dev = color.device
    v = torch.as_tensor(mesh.vertices, device=dev).double()
    o = torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    hi = torch.tensor(color.shape[:3], device=dev) - 1
    vi = torch.minimum(torch.clamp(torch.round(_div(v - o, spacing)).long(), min=0), hi)
    vc = torch.clamp(color[vi[:, 0], vi[:, 1], vi[:, 2]], 0, 1) * 255
    return vc.to(torch.uint8).cpu().numpy()


def extract_mesh_tsdf(
    depths, colors, alphas, Ks, w2cs, bounds_min, bounds_max,
    resolution: int = 128, **kw,
) -> Mesh:
    tsdf, color, weight, origin, spacing = tsdf_fusion(
        depths, colors, alphas, Ks, w2cs, bounds_min, bounds_max,
        resolution=resolution, **kw,
    )
    # unseen voxels stay at +1 (outside) so the surface closes at the
    # observation boundary
    mesh = marching_tetrahedra(tsdf, 0.0, origin=origin, spacing=spacing)
    if mesh.vertices.shape[0]:
        mesh = mesh._replace(colors=vertex_colors(mesh, color, origin, spacing))
    return mesh


def save_mesh_ply(mesh: Mesh, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    V, F = len(mesh.vertices), len(mesh.faces)
    has_color = mesh.colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {V}"]
    header += [f"property float {a}" for a in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += [
        f"element face {F}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.empty(V, vdt)
            rec["xyz"] = mesh.vertices
            rec["rgb"] = mesh.colors
        else:
            vdt = np.dtype([("xyz", "<f4", 3)])
            rec = np.empty(V, vdt)
            rec["xyz"] = mesh.vertices
        f.write(rec.tobytes())
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        frec = np.empty(F, fdt)
        frec["n"] = 3
        frec["idx"] = mesh.faces
        f.write(frec.tobytes())


class GaussianExtractor:
    """Render-all-views collector (reference mesh_utils.py:23-101). The maps
    stay on the state's device for the fusion."""

    def __init__(self, state, cfg, bg=None):
        self.state = state
        self.cfg = cfg
        dev = state.device
        self.bg = (torch.zeros(3, device=dev) if bg is None
                   else torch.as_tensor(bg, dtype=torch.float32, device=dev))
        self.clean()

    def clean(self):
        self.rgbmaps, self.depthmaps, self.alphamaps = [], [], []
        self.normals, self.cameras, self.num_instances = [], [], []

    @torch.no_grad()
    def reconstruction(self, cameras):
        from tpu_splat_torch.renderer import render

        self.clean()
        for cam in cameras:
            out = render(self.state, cam, self.cfg, self.bg, initial_stage=False)
            self.rgbmaps.append(out.render)
            self.depthmaps.append(out.surf_depth[..., 0])
            self.alphamaps.append(out.alpha[..., 0])
            self.normals.append(out.normal)
            self.num_instances.append(out.num_instances)
            self.cameras.append(cam)

    def export_image(self, path, normal_rot_quat=None):
        from tpu_splat_torch.eval.image_utils import save_image_u8

        for idx, rgb in enumerate(self.rgbmaps):
            save_image_u8(os.path.join(path, "renders", f"{idx:05d}.png"), rgb.cpu().numpy())
            n = self.normals[idx].cpu().numpy()
            if normal_rot_quat is not None:
                from tpu_splat_torch.core.transforms import quat_to_rotmat

                q = torch.as_tensor(np.asarray(normal_rot_quat, np.float32))[None]
                R = quat_to_rotmat(q)[0].numpy()
                n = n @ R.T
                n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)
            save_image_u8(os.path.join(path, "vis", f"normal_{idx:05d}.png"), n * 0.5 + 0.5)

    def export_mesh(self, bounds_min, bounds_max, resolution=128, **kw) -> Mesh:
        Ks = [c.K for c in self.cameras]
        w2cs = [c.world_view for c in self.cameras]
        return extract_mesh_tsdf(
            self.depthmaps, self.rgbmaps, self.alphamaps, Ks, w2cs,
            bounds_min, bounds_max, resolution=resolution, **kw,
        )
