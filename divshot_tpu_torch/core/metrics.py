"""Step metrics and the training phase (counterpart of
``divshot_tpu/core/metrics.py``, which is pure Python, copied): a CSV
metrics writer and a ``TrainingStatus`` state machine mirroring the
reference's (Loading_Prepare -> Colmap_Sfm -> GS -> Preprocess_Done ->
Training -> Training_Done / Loading_Failed).
"""

from __future__ import annotations

import csv
import enum
import os
import time


class TrainingStatus(enum.Enum):
    LOADING_PREPARE = "Loading_Prepare"
    COLMAP_SFM = "Colmap_Sfm"
    GS = "GS"
    PREPROCESS_DONE = "Preprocess_Done"
    TRAINING = "Training"
    TRAINING_DONE = "Training_Done"
    LOADING_FAILED = "Loading_Failed"


class MetricsWriter:
    """Append-only CSV of step metrics; cheap enough for every-step use."""

    def __init__(self, path: str | None):
        self.path = path
        self._file = None
        self._writer = None
        self._fields: list[str] | None = None
        self.t0 = time.time()

    def write(self, step: int, metrics: dict) -> None:
        if self.path is None:
            return
        row = {"step": step, "wall_s": round(time.time() - self.t0, 3)}
        row.update({k: (float(v) if hasattr(v, "item") or
                        isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        if self._writer is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fields = list(row.keys())
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=self._fields)
            self._writer.writeheader()
        self._writer.writerow({k: row.get(k, "") for k in self._fields})
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()


class PhaseTracker:
    """Phase name + progress fraction, as surfaced by the reference UI
    (``getCurrentTrainingPhaseName``/``getProgressOnCurrentPhase``)."""

    def __init__(self):
        self.status = TrainingStatus.LOADING_PREPARE
        self.progress = 0.0

    def set(self, status: TrainingStatus, progress: float = 0.0):
        self.status = status
        self.progress = float(progress)

    @property
    def phase_name(self) -> str:
        return self.status.value
