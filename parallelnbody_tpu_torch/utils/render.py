"""Dependency-free particle renderer. Counterpart of
`parallelnbody_tpu/utils/render.py`, in numpy on the host: orthographic
projection -> mass-weighted 2D histogram -> log tone-map -> PNG or binary
PPM (P6), no imaging libraries; an ASCII PLY exporter for 3D tools. The
tree-box overlay (show_tree) takes the occupied leaves' boxes from the
port's ops/bh.py leaf_aabbs on the given device.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

_AXES = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}


def write_png(path, img) -> Path:
    """Minimal PNG writer (stdlib zlib only). img: (H, W, 3) uint8."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    path.write_bytes(png)
    return path


def render_ppm(pos, mass=None, *, size=512, plane="xy", extent=None,
               path=None, gamma=0.5):
    """Render (N, 3) positions to an RGB image array (and optionally a .ppm).

    Returns the (size, size, 3) uint8 image. extent = half-width of the view
    (defaults to the 99th percentile radius so outliers don't shrink the
    interesting region)."""
    pos = np.asarray(pos)
    mass = np.ones(len(pos)) if mass is None else np.asarray(mass)
    ax = _AXES[plane]
    xy = pos[:, ax]
    if extent is None:
        extent = float(np.percentile(np.abs(xy), 99.0)) * 1.1 or 1.0

    ij = np.floor((xy + extent) / (2 * extent) * size).astype(int)
    keep = (ij[:, 0] >= 0) & (ij[:, 0] < size) & (ij[:, 1] >= 0) & (ij[:, 1] < size)
    ij, w = ij[keep], mass[keep]
    hist = np.zeros((size, size))
    np.add.at(hist, (size - 1 - ij[:, 1], ij[:, 0]), w)

    v = np.log1p(hist / max(hist.max(), 1e-30) * 1e3)
    v = (v / max(v.max(), 1e-30)) ** gamma
    # Dark-blue -> white colormap, no external deps.
    r = np.clip(v * 1.6 - 0.2, 0, 1)
    g = np.clip(v * 1.4 - 0.1, 0, 1)
    b = np.clip(v * 1.1 + 0.08 * (v > 0), 0, 1)
    img = (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)

    if path:
        write_image(path, img)
    return img


def write_image(path, img) -> Path:
    """Write an (H, W, 3) uint8 image as .png or binary .ppm by suffix."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".png":
        write_png(path, img)
    else:
        h, w, _ = img.shape
        with open(path, "wb") as f:
            f.write(f"P6 {w} {h} 255\n".encode())
            f.write(img.tobytes())
    return path


def draw_boxes(img, lo, hi, *, extent, plane="xy", color=(255, 64, 64)):
    """Overlay axis-aligned box outlines onto a rendered frame, in place.
    lo/hi: (L, 3) world-space AABB corners (non-finite rows are skipped)."""
    size = img.shape[0]
    ax = _AXES[plane]
    lo2 = np.asarray(lo)[:, ax]
    hi2 = np.asarray(hi)[:, ax]
    ok = np.isfinite(lo2).all(1) & np.isfinite(hi2).all(1)

    def to_px(xy):
        return np.clip(np.floor((xy + extent) / (2 * extent) * size), 0,
                       size - 1).astype(int)

    a = to_px(lo2[ok])
    b = to_px(hi2[ok])
    col = np.array(color, np.uint8)
    for (x0, y0), (x1, y1) in zip(a, b):
        r0, r1 = size - 1 - y1, size - 1 - y0  # rows (y up -> row down)
        img[r0, x0:x1 + 1] = col
        img[r1, x0:x1 + 1] = col
        img[r0:r1 + 1, x0] = col
        img[r0:r1 + 1, x1] = col
    return img


def tree_boxes(pos, mass, *, leaf_size, curve="hilbert"):
    """(lo, hi) numpy corners of the occupied leaves of the tree over
    torch tensors pos (N, 3), mass (N,), computed on their device
    (ops/bh.py leaf_aabbs) and copied to the host once."""
    from parallelnbody_tpu_torch.ops.bh import leaf_aabbs

    lo, hi, occ = leaf_aabbs(pos, mass, leaf_size=leaf_size, curve=curve)
    return lo[occ].cpu().numpy(), hi[occ].cpu().numpy()


def export_ply(path, pos, mass=None) -> Path:
    """ASCII PLY point cloud for external 3D viewers."""
    pos = np.asarray(pos)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = len(pos)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if mass is not None:
            f.write("property float mass\n")
        f.write("end_header\n")
        if mass is not None:
            for p, m in zip(pos, np.asarray(mass)):
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g} {m:.6g}\n")
        else:
            for p in pos:
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
    return path


def render_trajectory(traj_dir, out_dir=None, *, size=512, plane="xy",
                      extent=None, fmt="png", show_tree=False,
                      device="cuda") -> list:
    """Render every frame of a TrajectoryWriter manifest to PNG/PPM images.
    Uses a common extent across frames (from the first frame) so the
    sequence animates coherently.

    show_tree=True overlays the occupied tree-leaf bounding boxes per frame,
    computed on `device` (the card unless the caller names another); leaf
    size and curve come from the manifest's recorded config."""
    import torch

    from parallelnbody_tpu_torch.config import SimConfig
    from parallelnbody_tpu_torch.state import resolve_device

    traj_dir = Path(traj_dir)
    out_dir = Path(out_dir) if out_dir else traj_dir / "frames"
    manifest = json.loads((traj_dir / "manifest.json").read_text())
    cfg_d = manifest.get("config") or {}
    if show_tree:
        device = resolve_device(device)
    written = []
    for frame in manifest["frames"]:
        with np.load(traj_dir / frame["file"]) as z:
            pos, mass = z["pos"], z["mass"]
        if extent is None:
            ax = _AXES[plane]
            extent = float(np.percentile(np.abs(pos[:, ax]), 99.0)) * 1.3 or 1.0
        img = render_ppm(pos, mass, size=size, plane=plane, extent=extent)
        if show_tree:
            leaf_size = (cfg_d.get("bh_leaf_size", 0)
                         # 0 = auto, resolved for the device the boxes are
                         # computed on (a run on the card records its leaf)
                         or SimConfig(n=len(pos)).resolve_bh_leaf_size(
                             device))
            lo, hi = tree_boxes(torch.from_numpy(pos).to(device),
                                torch.from_numpy(mass).to(device),
                                leaf_size=leaf_size,
                                curve=cfg_d.get("bh_curve", "hilbert"))
            draw_boxes(img, lo, hi, extent=extent, plane=plane)
        out = out_dir / (Path(frame["file"]).stem + f"_{plane}.{fmt}")
        write_image(out, img)
        written.append(out)
    return written
