"""The procedural ray-traced benchmark scene "tpu_bricks" (counterpart of
``divshot_tpu/gsio/procedural.py``), rebuilt without a download.

A ray tracer that shares no code with the rasterizer under test renders a
toy-brick structure (boxes with stud spheres), a checkerboard ground
disc, two glossy spheres (view-dependent Blinn-Phong highlights) and a
directional sun with hard ray-traced shadows, as RGBA (alpha = hit mask)
in the NeRF-synthetic blender layout (``transforms_{train,test}.json``
and PNGs), which ``gsio.datasets`` loads. The scene and the poses are the
JAX module's numpy code (rng seeds 1234 and 42); the tracer is a torch
function on an explicit device.

  python -m divshot_tpu_torch.gsio.procedural --out DIR [--n_train 100]
      [--n_test 25] [--res 800] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from divshot_tpu_torch.gsio.png import write_png

# ---------------------------------------------------------------------------
# scene spec (numpy, deterministic)


def make_scene() -> dict:
    """Deterministic brick-toy scene. Returns dict of primitive arrays."""
    rng = np.random.default_rng(1234)
    palette = np.array([
        [0.85, 0.10, 0.10],   # red
        [0.10, 0.35, 0.85],   # blue
        [0.95, 0.80, 0.10],   # yellow
        [0.10, 0.70, 0.25],   # green
        [0.95, 0.95, 0.95],   # white
        [0.95, 0.45, 0.10],   # orange
    ], np.float32)

    boxes_min, boxes_max, boxes_col = [], [], []
    sph_c, sph_r, sph_col, sph_ks, sph_shin = [], [], [], [], []

    def brick(x, y, z, nx, nz, ci, unit=0.22, h=0.20):
        """An nx-by-nz stud brick with studs, at grid position (x, z),
        layer y."""
        x0, z0 = x * unit, z * unit
        y0 = y * h
        bmin = np.array([x0, y0, z0], np.float32)
        bmax = np.array([x0 + nx * unit, y0 + h, z0 + nz * unit], np.float32)
        boxes_min.append(bmin)
        boxes_max.append(bmax)
        boxes_col.append(palette[ci])
        for ix in range(nx):
            for iz in range(nz):
                sph_c.append([x0 + (ix + 0.5) * unit, y0 + h + 0.015,
                              z0 + (iz + 0.5) * unit])
                sph_r.append(0.055)
                sph_col.append(palette[ci])
                sph_ks.append(0.25)
                sph_shin.append(24.0)

    # base plate 8x8 + walls + a tower + a gate — an irregular structure
    brick(-4, 0, -4, 8, 8, 3)
    for i, (x, z, nx, nz, ci) in enumerate([
            (-4, -4, 4, 1, 0), (0, -4, 4, 1, 1), (-4, 3, 4, 1, 2),
            (0, 3, 4, 1, 5), (-4, -3, 1, 6, 0), (3, -3, 1, 6, 1)]):
        brick(x, 1, z, nx, nz, ci)
    for lvl in range(2, 6):
        brick(-4, lvl, -4, 2, 2, lvl % 6)        # corner tower
    brick(-1, 1, -1, 2, 2, 4)
    brick(-1, 2, -1, 2, 2, 0)
    brick(-3, 1, 1, 2, 1, 2)
    brick(1, 1, 1, 1, 2, 5)
    brick(2, 2, -4, 2, 1, 3)
    # scattered loose bricks
    for k in range(8):
        x, z = int(rng.integers(-7, 6)), int(rng.integers(-7, 6))
        if -5 < x < 5 and -5 < z < 5:
            continue
        brick(x, 0, z, int(rng.integers(1, 3)), int(rng.integers(1, 3)),
              int(rng.integers(0, 6)))

    # glossy spheres (view-dependent content)
    sph_c.append([0.95, 0.28, 0.95]); sph_r.append(0.28)
    sph_col.append([0.9, 0.2, 0.5]); sph_ks.append(0.9); sph_shin.append(96.0)
    sph_c.append([-1.05, 0.22, 1.15]); sph_r.append(0.22)
    sph_col.append([0.2, 0.8, 0.9]); sph_ks.append(0.9); sph_shin.append(96.0)

    return {
        "box_min": np.stack(boxes_min),
        "box_max": np.stack(boxes_max),
        "box_col": np.stack(boxes_col),
        "sph_c": np.asarray(sph_c, np.float32),
        "sph_r": np.asarray(sph_r, np.float32),
        "sph_col": np.asarray(sph_col, np.float32),
        "sph_ks": np.asarray(sph_ks, np.float32),
        "sph_shin": np.asarray(sph_shin, np.float32),
        # ground disc (checker) at y=0
        "ground_radius": np.float32(3.0),
        "light_dir": np.asarray([0.45, 1.0, 0.35], np.float32)
        / np.linalg.norm([0.45, 1.0, 0.35]),
    }


# ---------------------------------------------------------------------------
# ray tracer (torch; independent of raster/)


def _trace(spec: dict[str, torch.Tensor], origins: torch.Tensor,
           dirs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Trace rays (R, 3) -> (rgb (R, 3), alpha (R,)), float32 on the rays'
    device; ``spec`` is ``make_scene``'s arrays as float32 tensors there."""
    dev = origins.device
    INF = 1e9
    EPS = 1e-4
    bmin = spec["box_min"][None]           # (1, B, 3)
    bmax = spec["box_max"][None]
    o = origins[:, None, :]                # (R, 1, 3)
    d = dirs[:, None, :]

    def box_hit(o, d):
        """Slab test -> (t (R, B), normal (R, B, 3)); t = INF on a miss."""
        inv = 1.0 / torch.where(d.abs() < 1e-9, 1e-9, d)
        t0 = (bmin - o) * inv
        t1 = (bmax - o) * inv
        tsm = torch.minimum(t0, t1)
        tbg = torch.maximum(t0, t1)
        tn = tsm.amax(-1)
        tf = tbg.amin(-1)
        hit = (tn <= tf) & (tf > EPS)
        t = torch.where(hit & (tn > EPS), tn, torch.where(hit, tf, INF))
        # normal: the axis of the entering slab
        enter_axis = torch.argmax(tsm, dim=-1)                 # (R, B)
        sign = -torch.sign(torch.gather(
            d.expand(-1, enter_axis.shape[1], -1), -1,
            enter_axis[..., None]))[..., 0]
        n = torch.where(
            torch.arange(3, device=dev)[None, None, :]
            == enter_axis[..., None], sign[..., None], 0.0)
        return t, n

    def sphere_hit(o, d):
        c = spec["sph_c"][None]            # (1, S, 3)
        r = spec["sph_r"][None]            # (1, S)
        oc = o - c
        b = (oc * d).sum(-1)
        cq = (oc * oc).sum(-1) - r * r
        disc = b * b - cq
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, INF))
        t = torch.where(disc > 0, t, INF)
        p = o + t[..., None] * d
        n = (p - c) / torch.clamp_min(r[..., None], 1e-9)
        return t, n

    def plane_hit(o, d):
        o, d = o[:, 0], d[:, 0]
        t = torch.where(d[:, 1].abs() > 1e-7, -o[:, 1] / d[:, 1], INF)
        p = o + t[:, None] * d
        ok = (t > EPS) & (p[:, 0] ** 2 + p[:, 2] ** 2
                          < spec["ground_radius"] ** 2)
        return torch.where(ok, t, INF)

    tb, nb = box_hit(o, d)                 # (R, B), (R, B, 3)
    ts, ns = sphere_hit(o, d)              # (R, S)
    tp = plane_hit(o, d)                   # (R,)

    ib = torch.argmin(tb, dim=1)
    tb_min = torch.gather(tb, 1, ib[:, None])[:, 0]
    is_ = torch.argmin(ts, dim=1)
    ts_min = torch.gather(ts, 1, is_[:, None])[:, 0]

    t_hit = torch.minimum(torch.minimum(tb_min, ts_min), tp)
    hit = t_hit < INF * 0.5
    use_b = tb_min <= torch.minimum(ts_min, tp)
    use_s = (~use_b) & (ts_min <= tp)

    p = origins + t_hit[:, None] * dirs
    n_b = nb[torch.arange(nb.shape[0], device=dev), ib]
    n_s = ns[torch.arange(ns.shape[0], device=dev), is_]
    n_p = torch.tensor([0.0, 1.0, 0.0], device=dev).expand_as(n_b)
    normal = torch.where(use_b[:, None], n_b,
                         torch.where(use_s[:, None], n_s, n_p))

    checker = ((torch.floor(p[:, 0] / 0.5) + torch.floor(p[:, 2] / 0.5))
               % 2.0)[:, None]
    plane_col = torch.where(checker > 0.5,
                            torch.tensor([0.75, 0.75, 0.78], device=dev),
                            torch.tensor([0.22, 0.22, 0.25], device=dev))
    col_b = spec["box_col"][ib]
    col_s = spec["sph_col"][is_]
    base = torch.where(use_b[:, None], col_b,
                       torch.where(use_s[:, None], col_s, plane_col))
    ks = torch.where(use_s, spec["sph_ks"][is_], 0.12)
    shin = torch.where(use_s, spec["sph_shin"][is_], 16.0)

    # shadow ray (any hit toward the light)
    l = spec["light_dir"]
    so = (p + normal * 2e-3)[:, None, :]
    ld = l.expand_as(so)
    stb, _ = box_hit(so, ld)
    sts, _ = sphere_hit(so, ld)
    occl = (stb.amin(1) < INF * 0.5) | (sts.amin(1) < INF * 0.5)
    vis = torch.where(occl, 0.0, 1.0)

    ndl = torch.clamp_min((normal * l).sum(-1), 0.0)
    h = l - dirs
    h = h / torch.clamp_min(torch.sqrt((h * h).sum(-1, keepdim=True)), 1e-9)
    ndh = torch.clamp_min((normal * h).sum(-1), 0.0)
    spec_term = ks * vis * ndh ** shin
    rgb = base * (0.30 + 0.75 * ndl * vis)[:, None] + spec_term[:, None]
    rgb = torch.clamp(rgb, 0.0, 1.0)
    return torch.where(hit[:, None], rgb, 0.0), hit.float()


def scene_tensors(spec: dict, device) -> dict[str, torch.Tensor]:
    """``make_scene``'s arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in spec.items()}


def render_view(spec, c2w: np.ndarray, width: int, height: int,
                focal: float, *, device="cuda",
                chunk: int = 1 << 16) -> np.ndarray:
    """Render one view -> (H, W, 4) float32 RGBA. ``c2w`` is OpenGL
    convention (the camera looks down -Z), as stored in transforms.json;
    ``spec`` is ``make_scene()`` or its ``scene_tensors``. The rays are
    made on the host, as in JAX, and traced ``chunk`` at a time."""
    if not isinstance(spec["box_min"], torch.Tensor):
        spec = scene_tensors(spec, device)
    i, j = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    d_cam = np.stack([(j + 0.5 - width / 2) / focal,
                      -(i + 0.5 - height / 2) / focal,
                      -np.ones_like(j, np.float32)], -1).reshape(-1, 3)
    R, t = c2w[:3, :3].astype(np.float32), c2w[:3, 3].astype(np.float32)
    dirs = d_cam @ R.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = torch.as_tensor(dirs.astype(np.float32), device=device)
    origins = torch.as_tensor(t, device=device).expand_as(dirs)
    out = torch.empty((dirs.shape[0], 4), device=device)
    for s in range(0, dirs.shape[0], chunk):
        rgb, a = _trace(spec, origins[s:s + chunk], dirs[s:s + chunk])
        out[s:s + chunk, :3] = rgb
        out[s:s + chunk, 3] = a
    return out.reshape(height, width, 4).cpu().numpy()


# ---------------------------------------------------------------------------
# dataset generation (blender / NeRF-synthetic format)


def _hemisphere_c2w(azimuth: float, elevation: float,
                    radius: float) -> np.ndarray:
    """OpenGL c2w looking at the origin from spherical coords."""
    eye = np.array([radius * np.cos(elevation) * np.cos(azimuth),
                    radius * np.sin(elevation),
                    radius * np.cos(elevation) * np.sin(azimuth)])
    target = np.array([0.0, 0.45, 0.0])
    back = eye - target
    back /= np.linalg.norm(back)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    up2 = np.cross(back, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, back, eye
    return c2w


def generate_dataset(out_dir: str, *, n_train: int = 100, n_test: int = 25,
                     width: int = 800, height: int = 800,
                     fov_x_deg: float = 40.0, radius: float = 3.6,
                     device="cuda", verbose: bool = False) -> None:
    """Write the scene as a NeRF-synthetic-format dataset under ``out_dir``
    (train/r_i.png, test/r_i.png, transforms_{train,test}.json), traced
    on ``device``."""
    spec = scene_tensors(make_scene(), device)
    cam_angle_x = np.deg2rad(fov_x_deg)
    focal = 0.5 * width / np.tan(0.5 * cam_angle_x)
    rng = np.random.default_rng(42)

    for split, count in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        golden = np.pi * (3.0 - np.sqrt(5.0))
        for k in range(count):
            # quasi-uniform azimuth sweep; elevation 8..62 deg; the test
            # split phase-shifted so its views are held out
            az = (k * golden + (0.5 if split == "test" else 0.0)) \
                % (2 * np.pi)
            el = np.deg2rad(8.0 + 54.0 * ((k * 7 + 3) % count) / count)
            if split == "train":
                az += float(rng.uniform(-0.05, 0.05))
            c2w = _hemisphere_c2w(az, el, radius)
            rgba = render_view(spec, c2w, width, height, focal,
                               device=device)
            img = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
            name = f"r_{k}"
            write_png(os.path.join(out_dir, split, name + ".png"), img)
            frames.append({"file_path": f"./{split}/{name}",
                           "transform_matrix": c2w.tolist()})
            if verbose:
                print(f"[{split}] {k + 1}/{count}", flush=True)
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": float(cam_angle_x),
                       "frames": frames}, f)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser("divshot_tpu_torch procedural dataset")
    p.add_argument("--out", required=True)
    p.add_argument("--n_train", type=int, default=100)
    p.add_argument("--n_test", type=int, default=25)
    p.add_argument("--res", type=int, default=800)
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    generate_dataset(ns.out, n_train=ns.n_train, n_test=ns.n_test,
                     width=ns.res, height=ns.res,
                     device=torch.device(ns.device), verbose=True)


if __name__ == "__main__":
    main()
