"""Procedural meshes and missing-attribute generation
(``unclerenderer_tpu/scene/mesh.py``), vectorized numpy: the cube and UV
sphere of the D3D12 renderer's ``FMesh`` (``Mesh.cpp:34-188``),
area-weighted normals (``:190-240``) and UV-gradient tangents with
handedness and Gram-Schmidt (``:242-331``), with the reference's numbers
exactly.
"""

from __future__ import annotations

import numpy as np

from .gltf import GltfMesh, GltfPrimitive


def create_cube(size: float = 1.0) -> GltfMesh:
    """24-vertex cube matching ``FMesh::CreateCube`` (``Mesh.cpp:34-105``)."""
    h = size * 0.5
    # (position, normal, uv, tangent) per face, 4 verts per face.
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
    uvs_zpos = np.array([[0, 1], [0, 0], [1, 0], [1, 1]], np.float32)
    uvs_zneg = np.array([[0, 1], [0, 0], [1, 0], [1, 1]], np.float32)
    positions, normals, uvs, tangents = [], [], [], []
    for i, (pts, n, t) in enumerate(faces):
        positions.append(np.asarray(pts, np.float32))
        normals.append(np.tile(np.asarray(n, np.float32), (4, 1)))
        uvs.append(uvs_zpos if i == 4 else (uvs_zneg if i == 5 else uvs_std))
        tangents.append(np.tile(np.asarray(t, np.float32), (4, 1)))
    indices = []
    for f in range(6):
        b = f * 4
        indices += [b, b + 1, b + 2, b, b + 2, b + 3]
    mesh = GltfMesh(
        position=np.concatenate(positions),
        normal=np.concatenate(normals),
        uv=np.concatenate(uvs),
        tangent=np.concatenate(tangents),
        color=np.ones((24, 4), np.float32),
        indices=np.asarray(indices, np.uint32),
        name="Cube",
    )
    mesh.primitives = [GltfPrimitive(index_start=0, index_count=36)]
    return mesh


def create_sphere(radius: float = 1.0, slice_count: int = 32, stack_count: int = 16) -> GltfMesh:
    """UV sphere matching ``FMesh::CreateSphere`` (``Mesh.cpp:107-188``)."""
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
    mesh = GltfMesh(
        position=pos.astype(np.float32),
        normal=nrm.astype(np.float32),
        uv=uv.astype(np.float32),
        tangent=tan.astype(np.float32),
        color=np.ones((n_verts, 4), np.float32),
        indices=tris,
        name="Sphere",
    )
    mesh.primitives = [GltfPrimitive(index_start=0, index_count=int(tris.size))]
    return mesh


def _normals_valid(normal: np.ndarray) -> bool:
    lens = np.einsum("ij,ij->i", normal, normal)
    return bool(np.all(lens > 1e-8))


def generate_normals_if_missing(mesh: GltfMesh) -> None:
    """Area-weighted vertex normals (``FMesh::GenerateNormalsIfMissing``)."""
    if mesh.position is None or mesh.indices is None or mesh.indices.size < 3:
        return
    if _normals_valid(mesh.normal):
        return
    tris = mesh.indices.reshape(-1, 3)
    p0, p1, p2 = (mesh.position[tris[:, k]] for k in range(3))
    face_n = np.cross(p1 - p0, p2 - p0)  # unnormalized = area weighting
    accum = np.zeros_like(mesh.position)
    for k in range(3):
        np.add.at(accum, tris[:, k], face_n)
    lens = np.linalg.norm(accum, axis=1, keepdims=True)
    fallback = np.array([0.0, 0.0, 1.0], np.float32)
    out = np.where(lens > 1e-4, accum / np.maximum(lens, 1e-20), fallback)
    mesh.normal = out.astype(np.float32)


def _tangents_valid(tangent: np.ndarray) -> bool:
    lens = np.einsum("ij,ij->i", tangent[:, :3], tangent[:, :3])
    return bool(np.all(lens > 1e-8))


def generate_tangents_if_missing(mesh: GltfMesh) -> None:
    """UV-gradient tangents with handedness (``FMesh::GenerateTangentsIfMissing``)."""
    if mesh.position is None or mesh.indices is None or mesh.indices.size < 3:
        return
    if _tangents_valid(mesh.tangent):
        return
    tris = mesh.indices.reshape(-1, 3)
    p0, p1, p2 = (mesh.position[tris[:, k]] for k in range(3))
    uv0, uv1, uv2 = (mesh.uv[tris[:, k]] for k in range(3))
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = uv1 - uv0, uv2 - uv0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    ok = np.abs(det) >= 1e-8
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    tangent = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * inv
    bitangent = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * inv
    t_accum = np.zeros_like(mesh.position)
    b_accum = np.zeros_like(mesh.position)
    for k in range(3):
        np.add.at(t_accum, tris[:, k], tangent)
        np.add.at(b_accum, tris[:, k], bitangent)

    n = mesh.normal.copy()
    n_len = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(n_len > 1e-4, n / np.maximum(n_len, 1e-20), np.array([0.0, 0.0, 1.0], np.float32))

    t_len2 = np.einsum("ij,ij->i", t_accum, t_accum)
    b_len2 = np.einsum("ij,ij->i", b_accum, b_accum)
    degenerate = (t_len2 <= 1e-8) | (b_len2 <= 1e-8)

    # Gram-Schmidt orthonormalization against the normal.
    t = t_accum - n * np.einsum("ij,ij->i", n, t_accum)[:, None]
    t_norm = np.linalg.norm(t, axis=1, keepdims=True)
    t = t / np.maximum(t_norm, 1e-20)
    b = b_accum / np.maximum(np.linalg.norm(b_accum, axis=1, keepdims=True), 1e-20)
    handedness = np.where(np.einsum("ij,ij->i", np.cross(n, t), b) < 0.0, -1.0, 1.0)

    # Degenerate fallback: build an orthonormal tangent from the normal.
    ref = np.where(
        np.abs(n[:, 1:2]) < 0.99,
        np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n.shape[0], 1)),
        np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n.shape[0], 1)),
    )
    fb = np.cross(ref, n)
    fb /= np.maximum(np.linalg.norm(fb, axis=1, keepdims=True), 1e-20)

    t = np.where(degenerate[:, None], fb, t)
    handedness = np.where(degenerate, 1.0, handedness)
    mesh.tangent = np.concatenate([t, handedness[:, None]], axis=1).astype(np.float32)


def compute_mesh_bounds(mesh: GltfMesh):
    """(center, radius, bounds_min, bounds_max) like
    ``RendererUtils::ComputeMeshBounds``."""
    bmin = mesh.position.min(axis=0).astype(np.float32)
    bmax = mesh.position.max(axis=0).astype(np.float32)
    center = (bmin + bmax) * 0.5
    radius = float(np.max(np.linalg.norm(mesh.position - center, axis=1)))
    return center, max(radius, 1e-6), bmin, bmax
