"""The reference's deferred frame, in float64: what the D3D12 renderer's
deferred pipeline draws, written plainly from its description.

Culling (frustum planes, then the previous frame's hierarchical Z) ->
the shadow map (back faces of every visible model, nearest depth) -> the
camera's visibility (front faces, reverse Z; alpha-masked materials
tested at their own texel, trilinear under either material sampler, as
the Renderer's masked raster tests them: the D3D12 shader clips on the
anisotropic sample where that is the sampler) -> attributes and
materials (trilinear, or anisotropic, wrapping, the footprint from the
2x2 quad's derivatives, normal map) ->
GGX direct light with 4-tap PCF shadows, split-sum IBL, the sky where
nothing was drawn -> TAA (history clamped to the 3x3 neighbourhood) ->
auto exposure (16x16 block log-average, adapted) -> the Khronos PBR
Neutral tonemap and gamma -> RCAS sharpening -> bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .raster import DepthBuffer, Triangles, covered_pairs
from .scene import Scene

F64 = torch.float64
PI = 3.14159265  # the shaders' constant
LUMA = (0.2126, 0.7152, 0.0722)


# ---------------------------------------------------------------------------
# per-frame matrices (row vectors, as the D3D12 renderer's)
# ---------------------------------------------------------------------------

def _normalize_np(v):
    v = np.asarray(v, np.float64)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_to(eye, forward, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    z = _normalize_np(forward)
    x = _normalize_np(np.cross(up, z))
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
    m[3, :3] = [-x @ eye, -y @ eye, -z @ eye]
    return m


def perspective(fov_y: float, aspect: float, near: float = 0.1) -> np.ndarray:
    """Reverse-Z, infinite far: z_ndc = near / z_view."""
    m = np.zeros((4, 4))
    m[1, 1] = 1.0 / math.tan(fov_y * 0.5)
    m[0, 0] = m[1, 1] / aspect
    m[2, 3] = 1.0
    m[3, 2] = near
    return m


def halton(i: int, base: int) -> float:
    r, f = 0.0, 1.0 / base
    while i > 0:
        r += (i % base) * f
        i //= base
        f /= base
    return r


def light_view_proj(center, radius: float, to_light) -> np.ndarray:
    """The directional light's orthographic view-projection: the light
    2.5 radii from the scene's centre, a 2-radius square, depth over 0.1 ..
    5 radii."""
    eye = center + to_light * (radius * 2.5)
    ortho = np.eye(4)
    ortho[0, 0] = ortho[1, 1] = 1.0 / radius
    ortho[2, 2] = 1.0 / (radius * 5.0 - 0.1)
    ortho[3, 2] = -0.1 / (radius * 5.0 - 0.1)
    return look_to(eye, center - eye) @ ortho


def frame_params(scene: Scene, n: int, view: dict, width: int, height: int,
                 jitter: bool) -> dict:
    """Frame ``n``'s camera and light, from the traffic's ``view``
    (``camera_pos``, ``look_at``, ``light_direction``)."""
    eye = np.asarray(view["camera_pos"], np.float64)
    v = look_to(eye, np.asarray(view["look_at"], np.float64) - eye)
    p = perspective(scene.fov_y, width / height)
    pj = p.copy()
    if jitter:  # Halton(2, 3) in pixels, from the second frame on
        pj[2, 0] += 2.0 * (halton(n + 1, 2) - 0.5) / width
        pj[2, 1] += 2.0 * (halton(n + 1, 3) - 0.5) / height
    d = _normalize_np(view["light_direction"])
    to_light = np.array([d[0], -d[1], d[2]])  # the scene gives the light's travel
    return {"eye": eye, "view": v, "proj": p, "vp": v @ pj, "vp_cull": v @ p,
            "to_light": to_light, "light_vp": light_view_proj(scene.center, scene.radius,
                                                              to_light)}


def _t(scene: Scene, a):
    return torch.as_tensor(np.asarray(a, np.float64), device=scene.device)


def _clip(points, m):
    """(..., 3) points -> (..., 4) clip coordinates under row-vector ``m``."""
    return points @ m[:3] + m[3]


# ---------------------------------------------------------------------------
# culling
# ---------------------------------------------------------------------------

def _corners(scene: Scene):
    sel = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], dtype=F64,
                       device=scene.device)
    return scene.box_min[:, None] + (scene.box_max - scene.box_min)[:, None] * sel


def in_frustum(scene: Scene, vp) -> torch.Tensor:
    """Each model box against the six planes of ``vp`` (near, far at
    infinity): some corner on the inner side of every plane's normal."""
    c = [vp[:, i] for i in range(4)]
    planes = torch.stack([c[3] + c[0], c[3] - c[0], c[3] + c[1], c[3] - c[1], c[2], c[3] - c[2]])
    norm = planes[:, :3].norm(dim=1, keepdim=True)
    planes = planes / torch.where(norm > 0, norm, torch.ones_like(norm))
    pv = torch.where(planes[None, :, :3] >= 0, scene.box_max[:, None], scene.box_min[:, None])
    return ((pv * planes[None, :, :3]).sum(-1) + planes[None, :, 3] >= 0).all(dim=1)


def hzb_pyramid(depth: torch.Tensor) -> list:
    """The min-depth pyramid of a reverse-Z depth image: the first level at
    half its size, each next level half the last (at least 1), 2x2 minima,
    an odd edge row or column repeated, a surplus one dropped."""
    h, w = depth.shape[0] // 2, depth.shape[1] // 2
    levels, cur = [], depth
    while True:
        ch, cw = cur.shape
        if ch < 2 * h:
            cur = torch.cat([cur, cur[-1:]], 0)
        if cw < 2 * w:
            cur = torch.cat([cur, cur[:, -1:]], 1)
        cur = cur[:2 * h, :2 * w].reshape(h, 2, w, 2).amin(dim=(1, 3))
        levels.append(cur)
        if h == 1 and w == 1:
            return levels
        h, w = max(1, h // 2), max(1, w // 2)


def hzb_occluded(scene: Scene, vp, pyramid: list) -> torch.Tensor:
    """Each model box against the previous frame's pyramid: its screen
    rectangle's level (the log2 of its larger side in first-level texels),
    the minimum depth of that level's texels at the rectangle's four
    corners, behind which the box's nearest depth must lie."""
    p = _clip(_corners(scene), vp)
    w = p[..., 3]
    behind = (w <= 0).any(dim=1)
    ws = torch.where(w > 0, w, torch.ones_like(w))
    u = p[..., 0] / ws * 0.5 + 0.5
    v = 1.0 - (p[..., 1] / ws * 0.5 + 0.5)
    nearest = (p[..., 2] / ws).amax(dim=1)
    u0, u1, v0, v1 = u.amin(1), u.amax(1), v.amin(1), v.amax(1)
    off = (u1 < 0) | (v1 < 0) | (u0 > 1) | (v0 > 1)
    u0, u1, v0, v1 = (x.clamp(0, 1) for x in (u0, u1, v0, v1))
    h0, w0 = pyramid[0].shape
    side = torch.maximum((u1 - u0) * w0, (v1 - v0) * h0)
    level = torch.where(side > 1, torch.floor(torch.log2(side.clamp(min=1))),
                        torch.zeros_like(side)).clamp(0, len(pyramid) - 1).long()
    far = torch.full_like(nearest, float("inf"))
    for lv, img in enumerate(pyramid):
        sel = level == lv
        if not sel.any():
            continue
        lh, lw = img.shape
        xs = [(x[sel] * lw).long().clamp(max=lw - 1) for x in (u0, u1)]
        ys = [(y[sel] * lh).long().clamp(max=lh - 1) for y in (v0, v1)]
        d = torch.stack([img[y, x] for y in ys for x in xs]).amin(0)
        far[sel] = d
    return (nearest < far) & ~behind & ~off


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------

def bilinear_wrap(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(h, w, C) image at (n, 2) uvs, texel centres at half texels,
    wrapping."""
    h, w = img.shape[:2]
    tx, ty = uv[:, 0] * w - 0.5, uv[:, 1] * h - 0.5
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0)[:, None], (ty - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    xa, xb = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    ya, yb = torch.remainder(y0, h), torch.remainder(y0 + 1, h)
    top = img[ya, xa] * (1 - fx) + img[ya, xb] * fx
    bot = img[yb, xa] * (1 - fx) + img[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def trilinear_wrap(chain: list, uv: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """Trilinear tap of a mip chain: the two levels around ``lod`` (at
    least 0; past the last level, the last), blended by its fraction."""
    lod = lod.clamp(min=0)
    l0 = torch.floor(lod)
    frac = (lod - l0)[:, None]
    l0 = l0.clamp(max=len(chain) - 1).long()
    out = torch.zeros(uv.shape[0], chain[0].shape[-1], dtype=F64, device=uv.device)
    for lv in range(len(chain)):
        sel = (l0 == lv).nonzero(as_tuple=True)[0]
        if sel.numel() == 0:
            continue
        a = bilinear_wrap(chain[lv], uv[sel])
        b = bilinear_wrap(chain[min(lv + 1, len(chain) - 1)], uv[sel])
        out[sel] = a * (1 - frac[sel]) + b * frac[sel]
    return out


def cube_face_uv(d: torch.Tensor):
    """D3D cube addressing: direction (n, 3) -> (face, (n, 2) uv in [0, 1]);
    faces +X, -X, +Y, -Y, +Z, -Z."""
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(is_x, torch.where(x >= 0, 0, 1),
                       torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-300)
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    return face, torch.stack([(u / ma + 1) * 0.5, (v / ma + 1) * 0.5], -1)


def _face_direction(face, uc, vc):
    """Face-local centred coordinates (extrapolation allowed) -> direction."""
    one = torch.ones_like(uc)
    dirs = [torch.stack(v, -1) for v in ((one, -vc, -uc), (-one, -vc, uc), (uc, one, vc),
                                         (uc, -one, -vc), (uc, -vc, one), (-uc, -vc, -one))]
    out = dirs[0]
    for f in range(1, 6):
        out = torch.where((face == f)[:, None], dirs[f], out)
    return out


def _cube_texel(level: torch.Tensor, face, ix, iy):
    """Texel (ix, iy) of ``face`` on a (6, s, s, C) level; a texel past an
    edge is the adjacent face's texel nearest its centre's direction."""
    s = level.shape[1]
    out_of = (ix < 0) | (ix >= s) | (iy < 0) | (iy >= s)
    if out_of.any():
        uc = (ix.to(F64) + 0.5) / s * 2 - 1
        vc = (iy.to(F64) + 0.5) / s * 2 - 1
        f2, uv2 = cube_face_uv(_face_direction(face, uc, vc))
        jx = torch.floor(uv2[:, 0] * s).long().clamp(0, s - 1)
        jy = torch.floor(uv2[:, 1] * s).long().clamp(0, s - 1)
        face = torch.where(out_of, f2, face)
        ix, iy = torch.where(out_of, jx, ix), torch.where(out_of, jy, iy)
    return level[face, iy, ix]


def _cube_bilinear(level: torch.Tensor, face, uv):
    s = level.shape[1]
    tx, ty = uv[:, 0] * s - 0.5, uv[:, 1] * s - 0.5
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0)[:, None], (ty - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    top = _cube_texel(level, face, x0, y0) * (1 - fx) + _cube_texel(level, face, x0 + 1, y0) * fx
    bot = (_cube_texel(level, face, x0, y0 + 1) * (1 - fx)
           + _cube_texel(level, face, x0 + 1, y0 + 1) * fx)
    return top * (1 - fy) + bot * fy


def cube_trilinear(levels: list, d: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """Seamless trilinear cube tap (filtering across face edges)."""
    face, uv = cube_face_uv(d)
    lod = lod.clamp(min=0)
    l0 = torch.floor(lod)
    frac = (lod - l0)[:, None]
    l0 = l0.clamp(max=len(levels) - 1).long()
    out = torch.zeros(d.shape[0], 3, dtype=F64, device=d.device)
    for lv in range(len(levels)):
        sel = (l0 == lv).nonzero(as_tuple=True)[0]
        if sel.numel() == 0:
            continue
        a = _cube_bilinear(levels[lv], face[sel], uv[sel])
        b = _cube_bilinear(levels[min(lv + 1, len(levels) - 1)], face[sel], uv[sel])
        out[sel] = a * (1 - frac[sel]) + b * frac[sel]
    return out


def bilinear_clamp(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[:2]
    tx = (uv[:, 0] * w - 0.5).clamp(0, w - 1)
    ty = (uv[:, 1] * h - 0.5).clamp(0, h - 1)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0)[:, None], (ty - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def footprint_lod(dx, dy, size):
    """log2 of the longer screen axis of the footprint, in texels."""
    lx = ((dx * size) ** 2).sum(-1)
    ly = ((dy * size) ** 2).sum(-1)
    return 0.5 * torch.log2(torch.maximum(lx, ly).clamp(min=1e-12))


def sample_materials(scene: Scene, mat, uv, lod) -> torch.Tensor:
    """Each pixel's combined texel (n, 8) from its material's chain."""
    out = torch.zeros(uv.shape[0], 8, dtype=F64, device=uv.device)
    for m, chain in enumerate(scene.chains):
        sel = (mat == m).nonzero(as_tuple=True)[0]
        if sel.numel():
            out[sel] = trilinear_wrap(chain, uv[sel], lod[sel])
    return out


def sample_materials_aniso(scene: Scene, mat, uv, dx, dy, size, taps: int) -> torch.Tensor:
    """The anisotropic sampler (D3D12_FILTER_ANISOTROPIC, MaxAnisotropy =
    ``taps``): with the footprint's squared axes in texels rho_x =
    |dx * size|^2 and rho_y = |dy * size|^2, the larger rho_maj and the
    smaller rho_min (each at least 1e-12), the ratio n = sqrt(rho_maj /
    rho_min) clamped to [1, taps] and the level of detail 1/2 log2(max(
    rho_min, rho_maj / n^2)): the mean of ``taps`` trilinear taps at that
    level, spread along the major axis's uv derivative d at uv + d ((k +
    1/2) / taps - 1/2) (1 - 1/n), k = 0 .. taps - 1.  An isotropic
    footprint (n = 1) is the trilinear tap."""
    rho_x = ((dx * size) ** 2).sum(-1)
    rho_y = ((dy * size) ** 2).sum(-1)
    rho_maj = torch.maximum(rho_x, rho_y).clamp(min=1e-12)
    rho_min = torch.minimum(rho_x, rho_y).clamp(min=1e-12)
    n = torch.sqrt(rho_maj / rho_min).clamp(1.0, float(taps))
    lod = 0.5 * torch.log2(torch.maximum(rho_min, rho_maj / (n * n)))
    major = torch.where((rho_x >= rho_y)[:, None], dx, dy)
    spread = 1.0 - 1.0 / n
    out = torch.zeros(uv.shape[0], 8, dtype=F64, device=uv.device)
    for k in range(taps):
        t = ((k + 0.5) / taps - 0.5) * spread
        out += sample_materials(scene, mat, uv + major * t[:, None], lod)
    return out / taps


def material_size(scene: Scene, mat) -> torch.Tensor:
    sizes = torch.tensor([float(c[0].shape[0]) for c in scene.chains], dtype=F64,
                         device=mat.device)
    return sizes[mat]


# ---------------------------------------------------------------------------
# rasters
# ---------------------------------------------------------------------------

def shadow_map(scene: Scene, light_vp, draw, size: int) -> torch.Tensor:
    """The light's depth map: back faces of the ``draw`` triangles, the
    nearest depth, 1 where nothing is."""
    tri = Triangles(_clip(scene.pos, light_vp), size, size)
    buf = DepthBuffer(size, size, "min", scene.device, ids=False)
    for t, px, py, _e, depth in covered_pairs(tri, draw, front=False):
        buf.add(t, px, py, depth)
    return buf.images(size)[0]


def _alpha_passes(scene: Scene, tri: Triangles, t, px, py, e) -> torch.Tensor:
    """The alpha test of masked (pixel, triangle) pairs: the base colour's
    alpha at the pair's own level of detail (its uv's screen derivatives,
    analytically), times the material's alpha, at or above its cutoff."""
    a, b, c = tri.edges(t)
    uvk = scene.uv[t]  # (n, 3, 2)
    d = e.sum(1)
    uv = (e[..., None] * uvk).sum(1) / d[:, None]
    da, db = a.sum(1), b.sum(1)
    ua, ub = (a[..., None] * uvk).sum(1), (b[..., None] * uvk).sum(1)
    dudx = (ua - uv * da[:, None]) / d[:, None]
    dudy = (ub - uv * db[:, None]) / d[:, None]
    mat = scene.tri_material[t]
    size = material_size(scene, mat)[:, None]
    lod = footprint_lod(dudx, dudy, size)
    alpha = sample_materials(scene, mat, uv, lod)[:, 3] * scene.base_factor[mat, 3]
    return alpha >= scene.cutoff[mat]


def visibility(scene: Scene, vp, draw, width: int, height: int):
    """(depth (H, W), triangle id (H, W), -1 where empty): front faces,
    nearest in reverse Z; alpha-masked triangles only where they pass the
    alpha test and lie strictly nearer than the opaque ones."""
    tri = Triangles(_clip(scene.pos, vp), width, height)
    masked = scene.alpha_mask[scene.tri_material]
    opaque = DepthBuffer(width, height, "max", scene.device)
    for t, px, py, _e, depth in covered_pairs(tri, draw & ~masked, front=True):
        opaque.add(t, px, py, depth)
    depth, ids = opaque.images(height)
    if bool((draw & masked).any()):
        cut = DepthBuffer(width, height, "max", scene.device)
        for t, px, py, e, dep in covered_pairs(tri, draw & masked, front=True):
            ok = _alpha_passes(scene, tri, t, px, py, e)
            cut.add(t[ok], px[ok], py[ok], dep[ok])
        m_depth, m_ids = cut.images(height)
        take = m_depth > depth.clamp(min=0)
        depth, ids = torch.where(take, m_depth, depth), torch.where(take, m_ids, ids)
    return depth.clamp(min=0), ids, tri


# ---------------------------------------------------------------------------
# shading
# ---------------------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-20)


def _sat(x):
    return x.clamp(0, 1)


def ggx(albedo, metallic, roughness, f0, n, v, l):
    """The renderer's ``EvaluatePBR``: Lambert diffuse (not divided by pi)
    and GGX specular with Schlick-GGX k = (r + 1)^2 / 8, times N.L."""
    h = _unit(v + l)
    ndl, ndv, ndh, vdh = _sat(_dot(n, l)), _sat(_dot(n, v)), _sat(_dot(n, h)), _sat(_dot(v, h))
    a2 = (roughness * roughness) ** 2
    den = ndh * ndh * (a2 - 1) + 1
    d = a2 / (PI * den * den).clamp(min=1e-4)
    k = (roughness + 1) ** 2 / 8

    def g1(x):
        return x / (x * (1 - k) + k)

    f = f0 + (1 - f0) * ((1 - vdh) ** 5)[:, None]
    spec = (d * g1(ndv) * g1(ndl))[:, None] * f / (4 * ndl * ndv).clamp(min=1e-4)[:, None]
    kd = (1 - f) * (1 - metallic)[:, None]
    return (kd * albedo + spec) * ndl[:, None]


def pcf(depth_map, light_vp, pos, bias):
    """The deferred PCF: four bilinear comparison taps a texel apart (+0,
    +x, +y, +xy), averaged; a texel off the map, or a point off it, lit.
    Depths compare as the Renderer's PCF table stores them
    (``RenderSettings.shadow_table_u16``, the default): the map and the
    compare value each rounded up to 1/65535."""
    size = depth_map.shape[0]
    q_map = torch.ceil(depth_map.clamp(0, 1) * 65535.0)
    p = _clip(pos, light_vp)
    u, v = p[:, 0] * 0.5 + 0.5, p[:, 1] * -0.5 + 0.5
    cmp = torch.ceil((p[:, 2] - bias) * 65535.0).clamp(0, 65536)
    tx, ty = u * size - 0.5, v * size - 0.5
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = tx - x0, ty - y0
    x0, y0 = x0.long(), y0.long()

    def lit(dx, dy):
        x, y = x0 + dx, y0 + dy
        inside = (x >= 0) & (x < size) & (y >= 0) & (y < size)
        d = q_map[y.clamp(0, size - 1), x.clamp(0, size - 1)]
        return ((cmp <= d) | ~inside).to(F64)

    taps = {(dx, dy): lit(dx, dy) for dx in range(3) for dy in range(3)}

    def tap(ox, oy):
        top = taps[(ox, oy)] * (1 - fx) + taps[(ox + 1, oy)] * fx
        bot = taps[(ox, oy + 1)] * (1 - fx) + taps[(ox + 1, oy + 1)] * fx
        return top * (1 - fy) + bot * fy

    s = 0.25 * (tap(0, 0) + tap(1, 0) + tap(0, 1) + tap(1, 1))
    on_map = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return torch.where(on_map, s, torch.ones_like(s))


def sky(d, eye_y, to_light, light_color):
    """The renderer's sky: a zenith-to-horizon gradient, Rayleigh and Mie
    (g = 0.76) in-scattering of the sun, dimmed as the sun sets."""
    dev = d.device
    fall = ((1 - _sat(d[:, 1] * 0.5 + 0.5)) ** 3).clamp(0, 1)
    zen = torch.tensor([0.05, 0.12, 0.22], dtype=F64, device=dev)
    hor = torch.tensor([0.52, 0.68, 0.86], dtype=F64, device=dev)
    base = zen + (hor - zen) * fall[:, None]
    l = _unit(to_light)
    cos = _dot(d, l)
    h = max(float(eye_y), 0.0)
    rayleigh = 3 / (16 * PI) * (1 + cos * cos) * math.exp(-h / 8000)
    g = 0.76
    mie = (1 - g * g) / (4 * PI * ((1 + g * g - 2 * g * cos) ** 1.5).clamp(min=1e-3))
    mie = mie * math.exp(-h / 1200) * 0.8
    col = torch.tensor([0.650, 0.570, 0.475], dtype=F64, device=dev)
    scat = col * rayleigh[:, None] + light_color * mie[:, None]
    atten = min(max(math.exp(-max(1 - float(l[1]), 0.0) * 2), 0.0), 1.0)
    return base + scat * atten


def _luma(x):
    w = torch.tensor(LUMA, dtype=F64, device=x.device)
    return (x * w).sum(-1)


def _pad(img):
    return torch.nn.functional.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                   mode="replicate")[0].permute(1, 2, 0)


def taa(cur, history, weight):
    pad = _pad(cur)
    h, w = cur.shape[:2]
    nb = torch.stack([pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)])
    clamped = torch.minimum(torch.maximum(history, nb.amin(0)), nb.amax(0))
    return cur + (clamped - cur) * weight


def exposure(hdr, prev, valid: bool, cfg: dict, dt: float):
    """The adapted exposure value: key over the log-average of 16x16 block
    means, clamped, moved toward at the up or down speed."""
    h, w = hdr.shape[:2]
    gh, gw = min(16, h), min(16, w)
    ph, pw = h - h % gh, w - w % gw
    pooled = hdr[:ph, :pw].reshape(gh, ph // gh, gw, pw // gw, 3).mean(dim=(1, 3))
    log_avg = torch.log2(_luma(pooled.clamp(min=0)).clamp(min=1e-4)).mean()
    target = math.log2(max(cfg["auto_exposure_key"], 1e-4)) - log_avg
    target = target.clamp(math.log2(max(cfg["auto_exposure_min"], 1e-4)),
                          math.log2(max(cfg["auto_exposure_max"], 1e-4)))
    if not valid:
        return target
    speed = cfg["auto_exposure_speed_up"] if bool(target > prev) else \
        cfg["auto_exposure_speed_down"]
    alpha = min(max(1 - math.exp(-dt * speed), 0.0), 1.0)
    return prev + (target - prev) * alpha


def pbr_neutral(c):
    start, desat = 0.8 - 0.04, 0.15
    x = c.amin(-1, keepdim=True)
    c = c - torch.where(x < 0.08, x - 6.25 * x * x, torch.full_like(x, 0.04))
    peak = c.amax(-1, keepdim=True)
    d = 1 - start
    new_peak = 1 - d * d / (peak + d - start)
    comp = c * (new_peak / peak.clamp(min=1e-4))
    g = 1 - 1 / (desat * (peak - new_peak) + 1)
    return torch.where(peak < start, c, comp + (new_peak - comp) * g)


def rcas(c, sharpness):
    pad = _pad(c)
    h, w = c.shape[:2]
    n, s = pad[0:h, 1:1 + w], pad[2:2 + h, 1:1 + w]
    wv, e = pad[1:1 + h, 0:w], pad[1:1 + h, 2:2 + w]
    lo = torch.minimum(torch.minimum(torch.minimum(n, wv), torch.minimum(e, s)), c)
    hi = torch.maximum(torch.maximum(torch.maximum(n, wv), torch.maximum(e, s)), c)
    amp = (torch.minimum(lo, 2 - hi) / (hi + 1e-4)).clamp(0, 1)
    amp = torch.rsqrt(amp + 1e-4)
    wgt = -(1 / 5) / _luma(amp)
    cl = _luma(c)
    sharp = ((_luma(n) + _luma(wv) + _luma(e) + _luma(s)) * wgt + cl) / (4 * wgt + 1)
    sharp = sharp.clamp(0, 1)
    return c + ((c - cl[..., None] + sharp[..., None]) - c) * sharpness
