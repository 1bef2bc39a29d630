"""Structure-from-Motion pipeline (counterpart of ``divshot_tpu/gsio/sfm.py``):
the analog of the reference's bundled COLMAP pipeline (the closed trainer
ships ``sfm/`` binaries next to the exe and drives them during the
``Colmap_Sfm`` status; ``diverseshot-cli/source/gs_train.cpp:14``,
``editor.cpp:1518-1543``).

An external ``colmap`` (or ``glomap``) binary is driven when one is present
(``$DIVSHOT_COLMAP`` or on PATH) with the reference's settings: camera model
SIMPLE_PINHOLE (``editor.cpp:1809``), optional single-camera mode, quality
presets 0-3 mapping to feature/matcher budgets. Video inputs are expanded
to frames first, with the reference's frame-selection strategies
(Uniform / QualityBased / DiversityBased / Hybrid + fps,
``editor.cpp:1928-1943``).

Differences from JAX, which reads and writes frames with ``imageio``: a
video is decoded by an ``ffmpeg`` binary (``$DIVSHOT_FFMPEG`` or on PATH)
piped as raw ``rgb24``, and the kept frames are written as PNG by
``gsio/png.write_png``, named ``frame_%06d.png`` (JAX: ``.jpg``). Without
an ``ffmpeg`` binary decoding a video raises ``RuntimeError``, as a missing
COLMAP does.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from divshot_tpu_torch.gsio.png import write_png

VIDEO_EXTS = {".mp4", ".mov", ".avi", ".mkv", ".webm", ".m4v"}
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}

# quality presets 0..3 (SfM quality slider, editor dialog):
#   (max_image_size, max_num_features, sequential_overlap)
_QUALITY = {
    0: (1024, 4096, 5),
    1: (1600, 8192, 10),
    2: (2400, 8192, 10),
    3: (3200, 16384, 15),
}


class VideoStrategy:
    UNIFORM = 0
    QUALITY_BASED = 1
    DIVERSITY_BASED = 2
    HYBRID = 3


@dataclass
class SfmResult:
    scene_dir: str           # directory holding images/ + sparse/0
    num_images: int
    num_points: int


def colmap_binary() -> str | None:
    return os.environ.get("DIVSHOT_COLMAP") or shutil.which("colmap")


def ffmpeg_binary() -> str | None:
    return os.environ.get("DIVSHOT_FFMPEG") or shutil.which("ffmpeg")


def needs_sfm(source: str) -> bool:
    """True when ``source`` has no pose data (no COLMAP sparse model, no
    transforms.json), i.e. raw images or a video file."""
    if os.path.isfile(source):
        return os.path.splitext(source)[1].lower() in VIDEO_EXTS
    if not os.path.isdir(source):
        return False
    if os.path.exists(os.path.join(source, "transforms_train.json")) or \
            os.path.exists(os.path.join(source, "transforms.json")):
        return False
    for sub in ("sparse/0", "sparse", "colmap/sparse/0"):
        d = os.path.join(source, sub)
        if os.path.isdir(d) and any(
                os.path.exists(os.path.join(d, f"{n}.{e}"))
                for n in ("cameras",) for e in ("bin", "txt")):
            return False
    return True


# ---------------------------------------------------------------------------
# video -> frames (videoStrategy + videoFps)


def _frame_sharpness(frame: np.ndarray) -> float:
    """Variance-of-Laplacian sharpness score (QualityBased selection)."""
    g = frame.astype(np.float32).mean(-1) if frame.ndim == 3 else frame
    lap = (-4 * g[1:-1, 1:-1] + g[:-2, 1:-1] + g[2:, 1:-1]
           + g[1:-1, :-2] + g[1:-1, 2:])
    return float(lap.var())


def _frame_difference(a: np.ndarray, b: np.ndarray) -> float:
    sa = a[::8, ::8].astype(np.float32)
    sb = b[::8, ::8].astype(np.float32)
    return float(np.abs(sa - sb).mean())


def probe_video(video_path: str) -> tuple[int, int, float]:
    """-> (width, height, fps) of the first video stream, read from
    ``ffmpeg -i``'s stream line (30 fps when it names none)."""
    binary = ffmpeg_binary()
    if binary is None:
        raise RuntimeError(
            f"{video_path}: decoding a video needs an ffmpeg binary. Put "
            f"ffmpeg on PATH (or set $DIVSHOT_FFMPEG), or extract the "
            f"frames into a folder of images.")
    proc = subprocess.run([binary, "-hide_banner", "-i", video_path],
                          capture_output=True, text=True)
    for line in proc.stderr.splitlines():
        if "Video:" in line:
            size = re.search(r"\b(\d{2,5})x(\d{2,5})\b", line)
            fps = re.search(r"([\d.]+) fps", line)
            if size:
                return (int(size.group(1)), int(size.group(2)),
                        float(fps.group(1)) if fps else 30.0)
    raise RuntimeError(f"{video_path}: ffmpeg found no video stream:\n"
                       f"{proc.stderr[-2000:]}")


def decode_video(video_path: str, width: int,
                 height: int) -> Iterator[np.ndarray]:
    """The frames of ``video_path`` as (height, width, 3) uint8 arrays,
    decoded by ffmpeg and piped as raw rgb24."""
    proc = subprocess.Popen(
        [ffmpeg_binary(), "-v", "error", "-i", video_path, "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    size = width * height * 3
    try:
        while True:
            buf = proc.stdout.read(size)
            if len(buf) < size:
                break
            yield np.frombuffer(buf, np.uint8).reshape(height, width, 3)
    finally:
        proc.stdout.close()
        proc.kill()
        proc.wait()


def extract_video_frames(
    video_path: str, out_dir: str, *,
    strategy: int = VideoStrategy.UNIFORM,
    fps: float = 2.0,
    max_frames: int = 600,
    progress_cb: Callable[[str, float], None] | None = None,
    _frames=None, _src_fps: float | None = None,
) -> list[str]:
    """Extract training frames from a video file.

    Uniform: every 1/fps seconds. QualityBased: sharpest frame in each
    uniform window. DiversityBased: greedy selection by inter-frame
    difference. Hybrid: sharpest among sufficiently-different candidates.
    ``_frames``/``_src_fps`` inject an in-memory frame stream (tests /
    codec-less environments)."""
    os.makedirs(out_dir, exist_ok=True)
    if _frames is None:
        width, height, src_fps = probe_video(video_path)
        _frames = decode_video(video_path, width, height)
    else:
        src_fps = _src_fps or 30.0
    step = max(1, round(src_fps / max(fps, 1e-3)))

    saved: list[str] = []
    window: list[tuple[float, np.ndarray, int]] = []
    last_kept: np.ndarray | None = None
    diff_thresh = 6.0

    def keep(frame: np.ndarray, idx: int) -> None:
        nonlocal last_kept
        path = os.path.join(out_dir, f"frame_{idx:06d}.png")
        write_png(path, frame)
        saved.append(path)
        last_kept = frame

    for i, frame in enumerate(_frames):
        if len(saved) >= max_frames:
            break
        if strategy == VideoStrategy.UNIFORM:
            if i % step == 0:
                keep(frame, i)
        elif strategy == VideoStrategy.QUALITY_BASED:
            window.append((_frame_sharpness(frame), frame, i))
            if len(window) == step:
                _, best, bi = max(window, key=lambda t: t[0])
                keep(best, bi)
                window = []
        elif strategy == VideoStrategy.DIVERSITY_BASED:
            if last_kept is None or \
                    _frame_difference(frame, last_kept) > diff_thresh:
                keep(frame, i)
        else:  # HYBRID: diverse enough, then sharpest in window
            if last_kept is None or \
                    _frame_difference(frame, last_kept) > diff_thresh:
                window.append((_frame_sharpness(frame), frame, i))
                if len(window) == max(2, step // 2):
                    _, best, bi = max(window, key=lambda t: t[0])
                    keep(best, bi)
                    window = []
        if progress_cb and i % 50 == 0:
            progress_cb("extract_frames", min(len(saved) / max_frames, 1.0))
    if window:
        _, best, bi = max(window, key=lambda t: t[0])
        keep(best, bi)
    return saved


# ---------------------------------------------------------------------------
# COLMAP pipeline


def _run(cmd: list[str], progress_cb, stage: str, frac: float) -> None:
    if progress_cb:
        progress_cb(stage, frac)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{stage} failed ({proc.returncode}):\n{proc.stderr[-2000:]}")


def run_sfm(
    source: str, *,
    quality: int = 1,
    single_camera: bool = True,
    camera_model: str = "SIMPLE_PINHOLE",
    use_glomap: bool = False,
    video_strategy: int = VideoStrategy.UNIFORM,
    video_fps: float = 2.0,
    max_image_count: int = 600,
    progress_cb: Callable[[str, float], None] | None = None,
) -> SfmResult:
    """images-or-video -> COLMAP sparse reconstruction.

    Produces ``<scene>/images`` + ``<scene>/sparse/0`` consumable by
    ``gsio.datasets.load_colmap_dataset``. Requires a ``colmap`` binary
    ($DIVSHOT_COLMAP or PATH); raises with instructions otherwise."""
    binary = colmap_binary()
    if binary is None:
        raise RuntimeError(
            "COLMAP binary not found. Install colmap and put it on PATH "
            "(or set $DIVSHOT_COLMAP), or provide a scene with poses "
            "(COLMAP sparse model / transforms.json).")

    if os.path.isfile(source):  # video
        scene = os.path.splitext(source)[0] + "_scene"
        images_dir = os.path.join(scene, "images")
        extract_video_frames(
            source, images_dir, strategy=video_strategy, fps=video_fps,
            max_frames=max_image_count, progress_cb=progress_cb)
    else:
        scene = source
        images_dir = os.path.join(scene, "images")
        if not os.path.isdir(images_dir):
            # accept a bare directory of images
            imgs = [f for f in os.listdir(scene)
                    if os.path.splitext(f)[1].lower() in IMAGE_EXTS]
            if imgs:
                os.makedirs(images_dir, exist_ok=True)
                for f in imgs:
                    os.replace(os.path.join(scene, f),
                               os.path.join(images_dir, f))

    max_size, max_feats, overlap = _QUALITY.get(quality, _QUALITY[1])
    db = os.path.join(scene, "database.db")
    sparse = os.path.join(scene, "sparse")
    os.makedirs(sparse, exist_ok=True)

    _run([binary, "feature_extractor",
          "--database_path", db, "--image_path", images_dir,
          "--ImageReader.camera_model", camera_model,
          "--ImageReader.single_camera", "1" if single_camera else "0",
          "--SiftExtraction.max_image_size", str(max_size),
          "--SiftExtraction.max_num_features", str(max_feats)],
         progress_cb, "feature_extract", 0.1)

    _run([binary, "sequential_matcher",
          "--database_path", db,
          "--SequentialMatching.overlap", str(overlap),
          "--SequentialMatching.loop_detection", "0"],
         progress_cb, "match", 0.4)

    mapper = "glomap" if use_glomap and shutil.which("glomap") else binary
    _run([mapper, "mapper",
          "--database_path", db, "--image_path", images_dir,
          "--output_path", sparse],
         progress_cb, "mapper", 0.7)

    if progress_cb:
        progress_cb("done", 1.0)
    from divshot_tpu_torch.gsio import colmap as C
    model_dir = os.path.join(sparse, "0")
    cams, imgs, pts, _cols = C.load_sparse_model(model_dir)
    return SfmResult(scene_dir=scene, num_images=len(imgs),
                     num_points=pts.shape[0])
