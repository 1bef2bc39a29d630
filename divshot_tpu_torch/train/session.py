"""Interactive training session (counterpart of
``divshot_tpu/train/session.py``): the reference's ``GaussianTrainerScene``
editor-path API (call sites ``editor.cpp:841-860,1416-1654``,
``inspector_panel.cpp:799-999``).

A ``TrainerSession`` owns a background training thread and exposes the
contract the reference editor relies on:

- the ``TrainingStatus`` state machine (Loading_Prepare -> [Colmap_Sfm] ->
  GS -> Preprocess_Done -> Training -> Training_Done, error exit
  Loading_Failed; every exception is caught at the thread's edge and lands
  in ``error``);
- ``start_train`` / ``pause_train`` / ``resume`` / ``terminate`` /
  ``is_training``;
- live parameter snapshots for visualisation (``get_gaussian_*``, the
  analog of ``getGaussian{Position,SH0,SHN,Opcaities,Scalings,Rotations}Cpu``)
  every ``snapshot_every`` steps;
- camera accessors (``num_cameras``, ``get_camera``), SfM progress points
  (``get_points3d``);
- a config-update queue drained on the training thread between steps
  (mutex + queue, ``editor.cpp:1610-1618``);
- ``save_model`` / loss and phase progress accessors.

The port's choices:
- A snapshot is taken where the trainer steps (at set-up, then on the
  training thread, never by a reader): the alive rows are
  gathered on the device and copied to the host once, as float32 numpy
  arrays that the trainer never writes (a bf16 ``shN`` is cast first). So
  a snapshot costs the alive splats, not the capacity; the ``get_*``
  results are JAX's, which copies the whole capacity and masks on the
  host. Readers (the live viewer's HTTP thread) see numpy arrays and CPU
  tensors only, never a CUDA tensor.
- The default render arguments take the backend from the model type
  (``render_kwargs_from_config``: the surfel kernels for exact 2DGS) with
  an instance capacity of 2^20; JAX's default asks for ``"pallas"``,
  which trains 2DGS as flattened 3D gaussians. As in JAX the loop never
  grows the instance capacity.
- With no seed points the random init has min(100,000, ``cap_max``)
  points (JAX: always 100,000, which raises below that capacity).
- The config queue is drained before each step's test of ``num_iters``:
  a queued ``num_iters`` at or below the current step ends the run there
  (JAX takes one more step first), and a change queued after the run
  ended applies when ``start_train`` runs again (JAX's loop ends first).
- ``export_mesh`` extracts the mesh on the session's device (the
  snapshot moved there), its depths through the kernels.
"""

from __future__ import annotations

import math
import queue
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from divshot_tpu_torch.core.config import TrainConfig, auto_tune_config
from divshot_tpu_torch.core.metrics import TrainingStatus

# the snapshot's fields, in the packed row's order
_SNAP_FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN")


def default_render_kwargs(cfg: TrainConfig) -> dict[str, Any]:
    """The session's render arguments when none are given: the model
    type's kernel route and a fixed instance capacity of 2^20."""
    from divshot_tpu_torch.train.trainer import render_kwargs_from_config
    return {"backend": render_kwargs_from_config(cfg)["backend"],
            "instance_capacity": 1 << 20}


class TrainerSession:
    """Background-threaded trainer with live state introspection."""

    def __init__(self, cfg: TrainConfig, *,
                 render_kwargs: dict[str, Any] | None = None,
                 snapshot_every: int = 200, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.render_kwargs = render_kwargs or default_render_kwargs(cfg)
        self.snapshot_every = snapshot_every

        self.status = TrainingStatus.LOADING_PREPARE
        self.progress = 0.0          # progress within the current phase
        self.error: str | None = None
        self.current_loss = float("nan")
        self.current_psnr = float("nan")
        self.num_gaussians = 0
        self.train_seconds = 0.0     # wall time of the training loop

        self._trainer = None
        self._dataset = None
        self._eval_dataset = None
        self._sfm_points: np.ndarray | None = None
        self._sfm_colors: np.ndarray | None = None
        self._snapshot: dict[str, np.ndarray] | None = None
        self._snapshot_lock = threading.Lock()
        self.snapshot_generation = 0   # bumps per snapshot (live viewer)
        self._config_queue: "queue.Queue[Callable]" = queue.Queue()
        self._pause = threading.Event()
        self._parked = threading.Event()   # the loop sleeps at a pause
        self._terminate = threading.Event()
        self._thread: threading.Thread | None = None
        self._step = 0

    # ---- phase / status surface (inspector_panel.cpp:997-999) ----

    @property
    def phase_name(self) -> str:
        return self.status.value

    def get_progress_on_current_phase(self) -> float:
        return self.progress

    def is_training(self) -> bool:
        return (self.status == TrainingStatus.TRAINING
                and not self._pause.is_set())

    def is_paused(self) -> bool:
        """True once a pause has taken hold: the training thread waits at
        it, the step in flight when it was asked for finished."""
        return self._pause.is_set() and self._parked.is_set()

    def is_terminated(self) -> bool:
        return self._terminate.is_set() or self.status in (
            TrainingStatus.TRAINING_DONE, TrainingStatus.LOADING_FAILED)

    @property
    def current_iteration(self) -> int:
        return self._step

    @property
    def max_iterations(self) -> int:
        return self.cfg.num_iters

    @property
    def trainer(self):
        """The ``Trainer`` the session steps (None before loading)."""
        return self._trainer

    # ---- data loading (load_train_data / trainSetup) ----

    def load_train_data(self, source_path: str | None = None,
                        run_sfm: bool = False) -> None:
        """Load (or SfM-reconstruct) the dataset. Mirrors
        ``loadTrainData`` + ``trainSetup``; raises nothing: errors land in
        ``status == LOADING_FAILED`` / ``self.error``."""
        try:
            self.status = TrainingStatus.LOADING_PREPARE
            src = source_path or self.cfg.source_path
            from divshot_tpu_torch.gsio import sfm as SFM
            from divshot_tpu_torch.gsio.datasets import load_dataset

            if run_sfm or SFM.needs_sfm(src):
                self.status = TrainingStatus.COLMAP_SFM
                result = SFM.run_sfm(
                    src, quality=getattr(self.cfg, "sfm_quality", 1),
                    progress_cb=self._on_sfm_progress)
                src = result.scene_dir

            ds, eval_ds = load_dataset(
                src, self.cfg.dataset_type, device=self.device,
                max_width=self.cfg.max_image_width,
                max_height=self.cfg.max_image_height,
                eval_holdout=self.cfg.eval_holdout,
                max_images=self.cfg.max_image_count,
                white_background=self.cfg.white_background,
                use_mask=self.cfg.use_mask)
            self._dataset = ds
            self._eval_dataset = eval_ds
            self._sfm_points = ds.points
            self._sfm_colors = ds.colors
            self.cfg = auto_tune_config(self.cfg, ds.num_views)
            self.status = TrainingStatus.GS
            self._setup()
            self.status = TrainingStatus.PREPROCESS_DONE
        except Exception as exc:           # contract: never throw across the
            self.error = f"{exc}\n{traceback.format_exc()}"   # thread edge
            self.status = TrainingStatus.LOADING_FAILED

    def load_synthetic(self, dataset, params=None) -> None:
        """Inject an in-memory Dataset (tests/demo path); the session runs
        on the dataset's device."""
        self._dataset = dataset
        self.device = dataset.device
        self.cfg = auto_tune_config(self.cfg, dataset.num_views)
        self._setup(params)
        self.status = TrainingStatus.PREPROCESS_DONE

    def _setup(self, params=None) -> None:
        from divshot_tpu_torch.splat.gaussians import init_from_points
        from divshot_tpu_torch.train.trainer import Trainer
        if params is None:
            pts, cols = self._dataset.points, self._dataset.colors
            if pts is None:
                rng = np.random.default_rng(self.cfg.seed)
                n0 = min(100_000, int(self.cfg.densify.cap_max))
                pts = rng.uniform(-1.3, 1.3, (n0, 3)).astype(np.float32)
                cols = rng.uniform(0, 1, (n0, 3)).astype(np.float32)
            params = init_from_points(
                pts, cols, sh_degree=self.cfg.sh_degree,
                capacity=int(self.cfg.densify.cap_max), device=self.device)
        self._trainer = Trainer(self.cfg, self._dataset, params,
                                render_kwargs=self.render_kwargs)
        self._take_snapshot()

    def _on_sfm_progress(self, stage: str, frac: float) -> None:
        self.progress = frac

    # ---- training control (startTrain/pauseTrain/...) ----

    def start_train(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._pause.clear()
            return
        if self._trainer is None:
            raise RuntimeError("call load_train_data()/load_synthetic() first")
        self._terminate.clear()
        self._pause.clear()
        # set before the thread starts, so that a restarted session never
        # reads as done
        self.status = TrainingStatus.TRAINING
        self._thread = threading.Thread(target=self._train_loop, daemon=True)
        self._thread.start()

    def pause_train(self) -> None:
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    def terminate(self, join: bool = True) -> None:
        self._terminate.set()
        self._pause.clear()
        if join and self._thread is not None:
            self._thread.join(timeout=120.0)

    def close(self) -> None:
        """Terminate, and stop a streamed trainer's prefetch thread."""
        self.terminate()
        if self._trainer is not None:
            self._trainer.close()

    def update_config(self, fn: Callable[[TrainConfig], TrainConfig]) -> None:
        """Queue a config mutation; applied on the training thread between
        steps (the reference's mutex+queue contract,
        ``editor.cpp:1610-1618``). Learning rates and loss weights reach
        the next step as its ``hypers``; structural changes rebuild the
        step functions (``Trainer.apply_config``)."""
        self._config_queue.put(fn)

    # ---- the training thread (run_train_gaussian, editor.cpp:1597-1654) ----

    def _train_loop(self) -> None:
        try:
            if self.device.type == "cuda" and self.device.index is not None:
                # the current device is per thread
                torch.cuda.set_device(self.device)
            trainer = self._trainer
            t0 = time.perf_counter()
            while not self._terminate.is_set():
                if self._pause.is_set():
                    self._parked.set()
                    time.sleep(0.05)
                    continue
                self._parked.clear()
                while not self._config_queue.empty():
                    try:
                        self.cfg = self._config_queue.get_nowait()(self.cfg)
                        trainer.apply_config(self.cfg)
                    except queue.Empty:
                        break
                n = self.cfg.num_iters
                if self._step >= n:
                    break
                trainer.step_once()
                self._step += 1
                self.progress = self._step / n
                if self._step % 50 == 0 or self._step == n:
                    m = trainer.last_metrics
                    if m is not None:
                        self.current_loss = float(m["loss"])
                        self.current_psnr = float(m["psnr"])
                        self.num_gaussians = int(m["num_alive"])
                if self.snapshot_every and \
                        self._step % self.snapshot_every == 0:
                    self._take_snapshot()
            self._take_snapshot()
            self.train_seconds += time.perf_counter() - t0
            if not self._terminate.is_set():
                self.status = TrainingStatus.TRAINING_DONE
                self.progress = 1.0
        except Exception as exc:
            self.error = f"{exc}\n{traceback.format_exc()}"
            self.status = TrainingStatus.LOADING_FAILED

    # ---- live snapshots (getGaussian*Cpu) ----

    def _take_snapshot(self) -> None:
        """The alive rows of every field, gathered on the device and copied
        to the host in one float32 block; the arrays are views of that
        block, which nothing else holds."""
        p = self._trainer.state.params
        with torch.no_grad():
            idx = torch.nonzero(p.alive).squeeze(1)
            n = idx.shape[0]
            parts = []
            for f in _SNAP_FIELDS:
                t = getattr(p, f).index_select(0, idx).float()
                parts.append(t.reshape(n, math.prod(t.shape[1:])))
            widths = [t.shape[1] for t in parts]
            block = torch.cat(parts, 1).cpu().numpy()
        snap, col = {}, 0
        for f, w in zip(_SNAP_FIELDS, widths):
            snap[f] = block[:, col:col + w]
            col += w
        snap["opacity"] = snap["opacity"][:, 0]
        snap["shN"] = snap["shN"].reshape(n, widths[-1] // 3, 3)
        with self._snapshot_lock:
            self._snapshot = snap
            self.snapshot_generation += 1

    def _get(self, key: str) -> np.ndarray:
        with self._snapshot_lock:
            if self._snapshot is None:
                return np.zeros((0,))
            return np.array(self._snapshot[key])

    def get_gaussian_positions(self) -> np.ndarray:
        return self._get("means")

    def get_gaussian_sh0(self) -> np.ndarray:
        return self._get("sh0")

    def get_gaussian_shn(self) -> np.ndarray:
        return self._get("shN")

    def get_gaussian_opacities(self) -> np.ndarray:
        return self._get("opacity")

    def get_gaussian_scalings(self) -> np.ndarray:
        return self._get("scales")

    def get_gaussian_rotations(self) -> np.ndarray:
        return self._get("quats")

    def get_params_snapshot(self, device="cpu"):
        """Full alive-only ``GaussianParams`` on ``device`` (the CPU)."""
        from divshot_tpu_torch.splat.gaussians import GaussianParams
        with self._snapshot_lock:
            if self._snapshot is None:
                return None
            s = dict(self._snapshot)
        means = s.pop("means")
        degree = {0: 0, 3: 1, 8: 2, 15: 3}[s["shN"].shape[1]]
        return GaussianParams.create(means, sh_degree=degree, device=device,
                                     **s)

    # ---- cameras / SfM progress ----

    @property
    def num_cameras(self) -> int:
        return 0 if self._dataset is None else self._dataset.num_views

    def get_camera(self, i: int):
        return self._dataset.cameras[i]

    def get_points3d(self) -> tuple[np.ndarray, np.ndarray]:
        """SfM sparse cloud for live point-cloud display during loading."""
        if self._sfm_points is None:
            return np.zeros((0, 3)), np.zeros((0, 3))
        return self._sfm_points, (
            self._sfm_colors if self._sfm_colors is not None
            else np.full_like(self._sfm_points, 0.5))

    # ---- persistence (saveGaussianModel / exportMesh) ----

    def save_model(self, path: str) -> None:
        from divshot_tpu_torch.gsio.io import save_model
        save_model(path, self.get_params_snapshot(),
                   antialiased=self.cfg.raster.mip_antialiased)

    def export_mesh(self, path: str) -> None:
        """A mesh of the snapshot's splats from the first 32 training
        cameras, through the session's render arguments, written as OBJ."""
        from divshot_tpu_torch.viewer.mesh import extract_mesh
        params = self.get_params_snapshot(device=self.device)
        cams = [self.get_camera(i)
                for i in range(min(self.num_cameras, 32))]
        extract_mesh(params, cams, resolution=self.cfg.mesh_resolution,
                     out_path=path, render_kw=self.render_kwargs)

    def export_sparse_point_cloud(self, path: str) -> None:
        pts, cols = self.get_points3d()
        from divshot_tpu_torch.gsio.ply import save_point_cloud_ply
        save_point_cloud_ply(path, pts, cols)
