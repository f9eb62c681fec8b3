"""The benchmark's one traffic generator.

A traffic mix is a JSON file beside this one (``<traffic>.json``) whose
``generator`` key names one of the functions in :data:`GENERATORS`; the
rest of the file are its parameters.  Everything is drawn from the run's
seed: the same seed gives the same inputs.  The world, the trajectory
and the ray-cast renderer are a frozen copy of the port's
``io/synthetic.py``; the TUM tree follows ``io/tum_fixture.py::
write_tum_tree`` but writes its PNGs with the plain encoder below, so
the program's decoder never reads what the program's encoder wrote.

- ``corridor_sequences``: ``sequences`` distinct corridor walks of
  ``frames`` frames each, as ground masks on the device with noisy
  odometry.  The sways are a fixed set; the seed orders them and draws
  the odometry noise, so every seed asks for the same amount of work.
- ``tum_tree``: one walk written as a TUM RGB-D tree (``rgb/``, ``seg/``,
  ``rgb.txt``, ``groundtruth.txt``) under a work directory.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

from ..reference.geometry import camera, plane, se3
from ..reference.geometry.camera import Intrinsics

LABEL_SKY = 0
LABEL_GROUND = 1
LABEL_WALL_BASE = 2

# the flat colors of render_rgb (floor, wall, sky)
_FLOOR_RGB = (0.30, 0.24, 0.20)
_WALL_RGB = (0.82, 0.80, 0.75)
_SKY_RGB = (0.95, 0.95, 0.97)
_WALL_TINT = 0.06


def seed_of(seed: int, *salt: int) -> int:
    """A non-negative 63-bit seed for generators, from the run's seed
    (any whole number) and a salt."""
    h = seed % (1 << 63)
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + s) % (1 << 63)
    return h


def generator(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, *salt))


# --------------------------------------------------------------------------
# World, trajectory and renderer (frozen copy of the port's io/synthetic.py)
# --------------------------------------------------------------------------

def corridor_world(length: float, width: float, height: float, device,
                   max_walls: int = 16):
    """A straight corridor along +y with an end wall: (p0 (M,2), p1 (M,2),
    height (M,), valid (M,))."""
    hw = width / 2.0
    segs = [((-hw, 0.0), (-hw, length)), ((hw, 0.0), (hw, length)),
            ((-hw, length), (hw, length))]
    n = len(segs)
    p0 = torch.full((max_walls, 2), 1e6)
    p1 = torch.full((max_walls, 2), 1e6 + 1.0)
    for i, (a, b) in enumerate(segs):
        p0[i] = torch.tensor(a)
        p1[i] = torch.tensor(b)
    h = torch.full((max_walls,), float(height))
    valid = torch.arange(max_walls) < n
    return p0.to(device), p1.to(device), h.to(device), valid.to(device)


def _world_planes(p0, p1):
    d = p1 - p0
    n = torch.stack([d[:, 1], -d[:, 0], torch.zeros_like(d[:, 0])], -1)
    q0 = torch.cat([p0, torch.zeros_like(p0[:, :1])], -1)
    off = -torch.sum(n * q0, dim=-1)
    return plane.normalize(torch.cat([n, off[:, None]], dim=-1))


def _look_along(d):
    f = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    fx, fy = f[..., 0], f[..., 1]
    z = torch.zeros_like(fx)
    right = torch.stack([fy, -fx, z], dim=-1)
    down = torch.stack([z, z, -torch.ones_like(fx)], dim=-1)
    fwd = torch.stack([fx, fy, z], dim=-1)
    return torch.stack([right, down, fwd], dim=-1)


def corridor_trajectory(n: int, length: float, cam_height: float,
                        sway: float, device):
    """Straight walk down the corridor: (R_wc (n,3,3), t_wc (n,3))."""
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    a = torch.tensor(0.5, dtype=torch.float32, device=device)
    b = torch.tensor(length - 1.5, dtype=torch.float32, device=device)
    ys = torch.cat([a * (1 - s) + b * s, b[None]])
    xs = sway * torch.sin(ys * 2.0)
    t = torch.stack([xs, ys, torch.full_like(ys, cam_height)], dim=-1)
    d = torch.stack([torch.zeros_like(ys), torch.ones_like(ys)], dim=-1)
    return _look_along(d), t


def render_labels(K: Intrinsics, R_wc, t_wc, world, h: int, w: int):
    """Ray-cast one frame: labels (h, w) int32 (sky 0, ground 1, wall i
    2 + i)."""
    p0, p1, height, valid = world
    dev = R_wc.device
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    rays_c = camera.pixel_rays(K, torch.stack([uu, vv], dim=-1))
    rays_w = torch.einsum("ij,hwj->hwi", R_wc, rays_c)
    rz = rays_w[..., 2]
    tiny = torch.abs(rz) < 1e-9
    s_ground = -t_wc[2] / torch.where(tiny, torch.full_like(rz, 1e-9), rz)
    ground_ok = (s_ground > 1e-6) & ~tiny
    s_ground = torch.where(ground_ok, s_ground,
                           torch.full_like(s_ground, math.inf))
    pis = _world_planes(p0, p1)
    n, d = pis[:, :3], pis[:, 3]
    denom = torch.einsum("mi,hwi->hwm", n, rays_w)
    num = -(torch.einsum("mi,i->m", n, t_wc) + d)
    flat = torch.abs(denom) < 1e-9
    s_wall = num / torch.where(flat, torch.full_like(denom, 1e-9), denom)
    hit = t_wc + s_wall[..., None] * rays_w[:, :, None, :]
    seg = p1 - p0
    seg_len2 = torch.clamp(torch.sum(seg * seg, dim=-1), min=1e-12)
    rel = hit[..., :2] - p0
    u_par = torch.einsum("hwmi,mi->hwm", rel, seg) / seg_len2
    z_ok = (hit[..., 2] >= -1e-3) & (hit[..., 2] <= height + 1e-3)
    wall_ok = ((s_wall > 1e-6) & ~flat & (u_par >= 0.0) & (u_par <= 1.0)
               & z_ok & valid)
    s_wall = torch.where(wall_ok, s_wall, torch.full_like(s_wall, math.inf))
    s_best_wall, best_wall = torch.min(s_wall, dim=-1)
    s_all = torch.minimum(s_ground, s_best_wall)
    sky = torch.isinf(s_all)
    return torch.where(
        sky, LABEL_SKY,
        torch.where(s_best_wall < s_ground, LABEL_WALL_BASE + best_wall,
                    LABEL_GROUND)).to(torch.int32)


def render_rgb8(labels, tint_u, noise_n, noise: float) -> torch.Tensor:
    """Low-texture RGB (H, W, 3) uint8: per-wall tints plus pixel noise
    (the port's ``render_rgb``), rounded to 8 bits."""
    dev = labels.device
    floor = torch.tensor(_FLOOR_RGB, device=dev)
    wall = torch.tensor(_WALL_RGB, device=dev)
    sky = torch.tensor(_SKY_RGB, device=dev)
    tints = _WALL_TINT * (tint_u - 0.5)
    wall_col = wall + tints[torch.clamp(labels - LABEL_WALL_BASE, 0,
                                        63).long()]
    img = torch.where((labels == LABEL_GROUND)[..., None], floor,
                      torch.where((labels == LABEL_SKY)[..., None], sky,
                                  wall_col))
    img = torch.clamp(img + noise * noise_n, 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8)


def noisy_odometry(R, t, xi, sigma_t: float, sigma_r: float):
    """Relative poses between consecutive frames composed with
    exp(xi * (sigma_t x3, sigma_r x3))."""
    Rr, tr = se3.se3_between(R[:-1], t[:-1], R[1:], t[1:])
    sig = torch.tensor([sigma_t] * 3 + [sigma_r] * 3, device=xi.device)
    dR, dt = se3.se3_exp(xi * sig)
    return se3.se3_compose(Rr, tr, dR, dt)


def _intrinsics(config, device) -> Intrinsics:
    fx, fy, cx, cy = config["intrinsics"]
    return Intrinsics.create(fx, fy, cx, cy, device=device)


def _world(traffic, device):
    if traffic["world"] != "corridor":
        raise ValueError(f"unknown world {traffic['world']!r}")
    return corridor_world(traffic["world_length"], traffic["world_width"],
                          traffic["wall_height"], device)


# --------------------------------------------------------------------------
# Generators
# --------------------------------------------------------------------------

def corridor_sequences(traffic: dict, config: dict, seed: int, device,
                       workdir: str) -> dict:
    """``sequences`` corridor walks of ``frames`` frames: ground masks
    (S, N, H, W) bool, odometry (S, N, 3, 3) / (S, N, 3) and the start
    poses (S, 3, 3) / (S, 3), all on ``device``; each walk's ``sway``."""
    N, S = traffic["frames"], traffic["sequences"]
    sways = list(traffic["sways"])
    if len(sways) != S:
        raise ValueError("one sway per sequence")
    K = _intrinsics(config, device)
    world = _world(traffic, device)
    H, W = config["height"], config["width"]
    g = generator("cpu", seed, 1)
    order = torch.randperm(S, generator=g).tolist()
    gd = generator(device, seed, 2)
    xi = torch.randn((S, N, 6), generator=gd, device=device)
    masks = torch.empty((S, N, H, W), dtype=torch.bool, device=device)
    oR = torch.empty((S, N, 3, 3), device=device)
    ot = torch.empty((S, N, 3), device=device)
    R0 = torch.empty((S, 3, 3), device=device)
    t0 = torch.empty((S, 3), device=device)
    for s in range(S):
        R, t = corridor_trajectory(N + 1, traffic["world_length"],
                                   traffic["cam_height"], sways[order[s]],
                                   device)
        R0[s], t0[s] = R[0], t[0]
        for i in range(N):
            masks[s, i] = render_labels(K, R[i + 1], t[i + 1], world, H,
                                        W) == LABEL_GROUND
        oR[s], ot[s] = noisy_odometry(R, t, xi[s], traffic["odom_sigma_t"],
                                      traffic["odom_sigma_r"])
    return {"masks": masks, "odom_R": oR, "odom_t": ot, "R0": R0, "t0": t0,
            "sway": [sways[o] for o in order]}


def encode_png(path: str, img: np.ndarray, level: int) -> None:
    """Write an 8-bit gray (H, W) or RGB (H, W, 3) PNG: filter 0 on every
    row, one zlib stream."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    raw = np.zeros((h, 1 + img[0].size), np.uint8)
    raw[:, 1:] = img.reshape(h, -1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


def quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Rotation matrices -> TUM-order quaternions (x, y, z, w)."""
    w = np.sqrt(np.maximum(0.0, 1.0 + R[..., 0, 0] + R[..., 1, 1]
                           + R[..., 2, 2])) / 2.0
    w = np.maximum(w, 1e-12)
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    return np.stack([x, y, z, w], axis=-1)


def tum_tree(traffic: dict, config: dict, seed: int, device,
             workdir: str) -> dict:
    """One walk of ``frames`` frames written as a TUM tree under
    ``workdir``/tum: 8-bit RGB renders with pixel noise, 0/255 ground
    masks in ``seg/``, ground truth at each frame's stamp plus
    ``gt_stamp_jitter``.  Returns the tree's root, the masks (N, H, W)
    bool (host) and the stamps."""
    N = traffic["frames"]
    K = _intrinsics(config, device)
    world = _world(traffic, device)
    H, W = config["height"], config["width"]
    R, t = corridor_trajectory(N, traffic["world_length"],
                               traffic["cam_height"], traffic["sway"], device)
    gd = generator(device, seed, 3)
    tint_u = torch.rand((64, 3), generator=gd, device=device)
    root = os.path.join(workdir, "tum")
    for d in ("rgb", "seg"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    stamps = 1000.0 + np.arange(N) / traffic["fps"]
    masks = np.zeros((N, H, W), bool)
    lines = []
    for i in range(N):
        lab = render_labels(K, R[i], t[i], world, H, W)
        noise_n = torch.randn((H, W, 3), generator=gd, device=device)
        rgb = render_rgb8(lab, tint_u, noise_n, traffic["rgb_noise"])
        m = (lab == LABEL_GROUND).cpu().numpy()
        masks[i] = m
        name = f"{stamps[i]:.6f}.png"
        encode_png(os.path.join(root, "rgb", name), rgb.cpu().numpy(),
                   traffic["png_level"])
        encode_png(os.path.join(root, "seg", name),
                   m.astype(np.uint8) * np.uint8(255), traffic["png_level"])
        lines.append(f"{stamps[i]:.6f} rgb/{name}")

    def index(path, header, rows):
        with open(os.path.join(root, path), "w") as f:
            f.write(f"# {header}\n# synthetic corridor, benchmark traffic\n")
            f.write("\n".join(rows) + "\n")

    index("rgb.txt", "color images", lines)
    R_np, t_np = R.cpu().numpy(), t.cpu().numpy()
    q = quat_xyzw(R_np)
    index("groundtruth.txt", "ground truth trajectory", [
        f"{gs:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
        f"{qi[0]:.6f} {qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f}"
        for gs, p, qi in zip(stamps + traffic["gt_stamp_jitter"], t_np, q)])
    return {"root": root, "masks": masks, "stamps": stamps}


GENERATORS = {
    "corridor_sequences": corridor_sequences,
    "tum_tree": tum_tree,
}


def make(traffic: dict, config: dict, seed: int, device, workdir: str):
    """The inputs of one run: ``traffic``'s generator at the run's seed."""
    return GENERATORS[traffic["generator"]](traffic, config, seed, device,
                                            workdir)
