"""Procedural meshes (``unclerenderer_tpu/scene/mesh.py``): the cube and
UV sphere of the reference renderer's ``FMesh`` and its mesh bounds, with
the reference's numbers exactly.  The meshes come back as ``Mesh``, the
vertex and index arrays of the reference's ``GltfMesh`` (its glTF
primitive sections are not needed: each procedural mesh is one section).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    position: np.ndarray = None  # (N, 3) f32
    normal: np.ndarray = None    # (N, 3) f32
    uv: np.ndarray = None        # (N, 2) f32
    tangent: np.ndarray = None   # (N, 4) f32, w = handedness
    color: np.ndarray = None     # (N, 4) f32
    indices: np.ndarray = None   # (M,) u32, M % 3 == 0
    name: str = ""


def create_cube(size: float = 1.0) -> Mesh:
    """24-vertex cube matching ``FMesh::CreateCube``."""
    h = size * 0.5
    # (position, normal, tangent) per face, 4 verts per face.
    faces = [
        # +X
        ([[h, -h, -h], [h, -h, h], [h, h, h], [h, h, -h]], [1, 0, 0], [0, 0, 1, 1]),
        # -X
        ([[-h, -h, h], [-h, -h, -h], [-h, h, -h], [-h, h, h]], [-1, 0, 0], [0, 0, -1, 1]),
        # +Y
        ([[-h, h, -h], [h, h, -h], [h, h, h], [-h, h, h]], [0, 1, 0], [1, 0, 0, 1]),
        # -Y
        ([[-h, -h, h], [h, -h, h], [h, -h, -h], [-h, -h, -h]], [0, -1, 0], [1, 0, 0, 1]),
        # +Z
        ([[-h, -h, h], [-h, h, h], [h, h, h], [h, -h, h]], [0, 0, 1], [1, 0, 0, 1]),
        # -Z
        ([[h, -h, -h], [h, h, -h], [-h, h, -h], [-h, -h, -h]], [0, 0, -1], [-1, 0, 0, 1]),
    ]
    uvs_std = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    uvs_z = np.array([[0, 1], [0, 0], [1, 0], [1, 1]], np.float32)  # +Z and -Z faces
    positions, normals, uvs, tangents = [], [], [], []
    for i, (pts, n, t) in enumerate(faces):
        positions.append(np.asarray(pts, np.float32))
        normals.append(np.tile(np.asarray(n, np.float32), (4, 1)))
        uvs.append(uvs_z if i >= 4 else uvs_std)
        tangents.append(np.tile(np.asarray(t, np.float32), (4, 1)))
    indices = []
    for f in range(6):
        b = f * 4
        indices += [b, b + 1, b + 2, b, b + 2, b + 3]
    return Mesh(
        position=np.concatenate(positions),
        normal=np.concatenate(normals),
        uv=np.concatenate(uvs),
        tangent=np.concatenate(tangents),
        color=np.ones((24, 4), np.float32),
        indices=np.asarray(indices, np.uint32),
        name="Cube",
    )


def create_sphere(radius: float = 1.0, slice_count: int = 32, stack_count: int = 16) -> Mesh:
    """UV sphere matching ``FMesh::CreateSphere``."""
    slice_count = max(3, slice_count)
    stack_count = max(2, stack_count)
    v = np.arange(stack_count + 1, dtype=np.float32)[:, None] / stack_count
    u = np.arange(slice_count + 1, dtype=np.float32)[None, :] / slice_count
    phi = v * np.pi
    theta = u * 2.0 * np.pi
    sp, cp = np.sin(phi), np.cos(phi)
    st, ct = np.sin(theta), np.cos(theta)
    x = radius * sp * ct
    y = radius * cp * np.ones_like(ct)
    z = radius * sp * st
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([sp * ct, cp * np.ones_like(ct), sp * st], axis=-1).reshape(-1, 3)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    tx = np.where(np.abs(sp) > 1e-4, -st * sp, 1.0) * np.ones_like(ct)
    tz = np.where(np.abs(sp) > 1e-4, ct * sp, 0.0)
    tan3 = np.stack([tx, np.zeros_like(tx), tz], axis=-1).reshape(-1, 3)
    tan3 /= np.maximum(np.linalg.norm(tan3, axis=1, keepdims=True), 1e-20)
    tan = np.concatenate([tan3, np.ones((tan3.shape[0], 1), np.float32)], axis=1)
    uv = np.stack(
        [np.tile(u, (stack_count + 1, 1)), np.tile(v, (1, slice_count + 1))], axis=-1
    ).reshape(-1, 2)

    stacks = np.arange(stack_count, dtype=np.uint32)[:, None]
    slices = np.arange(slice_count, dtype=np.uint32)[None, :]
    a = stacks * (slice_count + 1) + slices
    b = a + slice_count + 1
    tris = np.stack(
        [a, b, a + 1, a + 1, b, b + 1], axis=-1
    ).reshape(-1).astype(np.uint32)
    n_verts = pos.shape[0]
    return Mesh(
        position=pos.astype(np.float32),
        normal=nrm.astype(np.float32),
        uv=uv.astype(np.float32),
        tangent=tan.astype(np.float32),
        color=np.ones((n_verts, 4), np.float32),
        indices=tris,
        name="Sphere",
    )


def compute_mesh_bounds(mesh: Mesh):
    """(center, radius, bounds_min, bounds_max) like
    ``RendererUtils::ComputeMeshBounds``."""
    bmin = mesh.position.min(axis=0).astype(np.float32)
    bmax = mesh.position.max(axis=0).astype(np.float32)
    center = (bmin + bmax) * 0.5
    radius = float(np.max(np.linalg.norm(mesh.position - center, axis=1)))
    return center, max(radius, 1e-6), bmin, bmax
