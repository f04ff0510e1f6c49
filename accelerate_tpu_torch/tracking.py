"""Experiment trackers: the port of `accelerate_tpu.tracking`.

`GeneralTracker` is the interface every tracker implements; `JSONLTracker`
(``log_with="jsonl"``) writes one JSON object per call into
``<logging_dir>/<run>.metrics.jsonl``, the reference's format line for line.
`filter_trackers` turns ``Accelerator(log_with=...)`` into trackers as the
reference does: an unknown name raises, and a known tracker whose package is
missing is skipped with a warning. The reference's other seven trackers
(tensorboard, wandb, mlflow, comet_ml, aim, clearml, dvclive) are not ported
yet (ROADMAP Queue 1, item 33): naming one whose package is installed
raises NotImplementedError. Tracking is host-side and logs on the main
process only. ``log_images`` and ``log_table`` (reference
`tracking.py:59-70, 175-205`): the JSONL tracker writes each image as a uint8
HWC ``.npy`` file beside its metrics and logs the paths, and a table as its
columns and stringified rows; a tracker without them raises
NotImplementedError.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import math
import os
import time
from typing import Any

import numpy as np

from .utils.operations import listify


class GeneralTracker:
    """Tracker interface (reference `tracking.py:38`): subclasses set
    ``name`` and ``requires_logging_directory`` and implement
    ``store_init_configuration`` and ``log``."""

    name: str = "base"
    requires_logging_directory: bool = False
    main_process_only: bool = True

    @property
    def tracker(self) -> Any:
        return None

    def store_init_configuration(self, values: dict) -> None:
        raise NotImplementedError

    def log(self, values: dict, step: int | None = None, **kwargs: Any) -> None:
        raise NotImplementedError

    def log_images(self, values: dict, step: int | None = None, **kwargs: Any) -> None:
        """Log a dict of name -> image (HW, HWC or CHW, or an NHWC batch;
        float in [0, 1] or integer 0-255)."""
        raise NotImplementedError(f"Tracker {self.name!r} does not support log_images")

    def log_table(self, table_name: str, columns: list[str] | None = None,
                  data: list[list[Any]] | None = None, dataframe: Any = None,
                  step: int | None = None, **kwargs: Any) -> None:
        """Log a table as ``columns`` and ``data`` rows, or a dataframe."""
        raise NotImplementedError(f"Tracker {self.name!r} does not support log_table")

    def finish(self) -> None:
        pass


def _table_rows(columns: list[str] | None, data: list[list[Any]] | None,
                dataframe: Any) -> tuple[list[str], list[list[Any]]]:
    """(columns, rows) from either input; default column names ``col_<i>``."""
    if dataframe is not None:
        return list(map(str, dataframe.columns)), dataframe.values.tolist()
    if data is None:
        raise ValueError("log_table needs either `data` (+ optional `columns`) or `dataframe`")
    if columns is None:
        columns = [f"col_{i}" for i in range(len(data[0]))] if data else []
    return columns, data


def _image_to_uint8_hwc(img: Any) -> np.ndarray:
    """An HW, HWC or CHW image (float in [0, 1], or integer counts) as uint8
    HWC."""
    if hasattr(img, "detach"):
        img = img.detach().float().cpu().numpy()
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected HW or HWC image, got shape {arr.shape}")
    if arr.shape[0] in (1, 3, 4) and arr.shape[2] not in (1, 3, 4):
        arr = np.moveaxis(arr, 0, -1)  # CHW -> HWC
    if arr.dtype != np.uint8:
        if np.issubdtype(arr.dtype, np.integer):
            arr = np.clip(arr, 0, 255).astype(np.uint8)  # counts, not [0, 1]
        else:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return arr


def _expand_image_keys(values: dict) -> Any:
    """(key, uint8 HWC) pairs; an NHWC batch's members get ``_<i>``."""
    for key, value in values.items():
        if hasattr(value, "detach"):
            value = value.detach().float().cpu().numpy()
        arr = np.asarray(value)
        images = [_image_to_uint8_hwc(x) for x in arr] if arr.ndim == 4 else [_image_to_uint8_hwc(arr)]
        if len(images) == 1:
            yield key, images[0]
        else:
            for i, image in enumerate(images):
                yield f"{key}_{i}", image


class JSONLTracker(GeneralTracker):
    """One JSON object per call, appended to
    ``<logging_dir>/<run_name>.metrics.jsonl``: the run's configuration as
    ``{"_config": ..., "_ts": ...}``, then each ``log`` as its values with
    ``_step`` and ``_ts``. Tensors and arrays are written as numbers and
    lists; a non-finite float as null."""

    name = "jsonl"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: str | os.PathLike | None = None):
        self.run_name = run_name
        logging_dir = logging_dir or "."
        os.makedirs(logging_dir, exist_ok=True)
        self.path = os.path.join(logging_dir, f"{run_name}.metrics.jsonl")
        self._fh = open(self.path, "a")
        self._media_seq = 0

    @property
    def tracker(self) -> Any:
        return self._fh

    def _write(self, entry: dict) -> None:
        self._fh.write(json.dumps(entry, allow_nan=False) + "\n")
        self._fh.flush()

    def store_init_configuration(self, values: dict) -> None:
        self._write({"_config": values, "_ts": time.time()})

    def log(self, values: dict, step: int | None = None, **kwargs: Any) -> None:
        entry = dict(listify(values))
        entry["_step"] = step
        entry["_ts"] = time.time()
        self._write({k: None if isinstance(v, float) and not math.isfinite(v) else v
                     for k, v in entry.items()})

    def log_images(self, values: dict, step: int | None = None, **kwargs: Any) -> None:
        """Each image as a ``.npy`` under ``<run_name>.media/`` beside the
        metrics file, named by key, step and a sequence number (keys that
        sanitize alike and repeated steps never overwrite); the row logs
        the paths under ``_images``."""
        media_dir = os.path.join(os.path.dirname(self.path), f"{self.run_name}.media")
        os.makedirs(media_dir, exist_ok=True)
        paths = {}
        for key, image in _expand_image_keys(values):
            self._media_seq += 1
            out = os.path.join(media_dir, f"{key.replace('/', '_')}_"
                               f"{step if step is not None else 'x'}_{self._media_seq}.npy")
            np.save(out, image)
            paths[key] = out
        self.log({"_images": paths}, step=step)

    def log_table(self, table_name: str, columns: list[str] | None = None,
                  data: list[list[Any]] | None = None, dataframe: Any = None,
                  step: int | None = None, **kwargs: Any) -> None:
        columns, rows = _table_rows(columns, data, dataframe)
        self.log({"_table": {"name": table_name, "columns": columns,
                             "rows": [[str(c) for c in r] for r in rows]}}, step=step)

    def finish(self) -> None:
        self._fh.close()


# the reference's trackers that need a package, and the packages that stand
# for each (any one of them present counts as installed)
PACKAGE_TRACKERS: dict[str, tuple[str, ...]] = {
    "tensorboard": ("tensorboard", "tensorboardX"),
    "wandb": ("wandb",),
    "mlflow": ("mlflow",),
    "comet_ml": ("comet_ml",),
    "aim": ("aim",),
    "clearml": ("clearml",),
    "dvclive": ("dvclive",),
}
LOGGER_TYPE_TO_CLASS: dict[str, type[GeneralTracker]] = {"jsonl": JSONLTracker}


def _installed(name: str) -> bool:
    return any(importlib.util.find_spec(p) is not None for p in PACKAGE_TRACKERS[name])


def get_available_trackers() -> list[str]:
    """The trackers ``log_with="all"`` turns on: the ported ones."""
    return list(LOGGER_TYPE_TO_CLASS)


def filter_trackers(log_with: Any, logging_dir: str | os.PathLike | None, project_name: str,
                    config: dict | None, init_kwargs: dict) -> list[GeneralTracker]:
    """The trackers ``log_with`` names (a name, a `GeneralTracker`, or a list
    of either; ``"all"`` for every available one), each built for
    ``project_name`` with its ``init_kwargs`` and given ``config``
    (reference `tracking.py:585`)."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    trackers: list[GeneralTracker] = []
    names: list[str] = []
    for entry in log_with:
        if isinstance(entry, GeneralTracker):
            trackers.append(entry)
        elif str(entry).lower() == "all":
            names.extend(get_available_trackers())
        else:
            names.append(str(entry).lower())
    for name in dict.fromkeys(names):
        if name not in LOGGER_TYPE_TO_CLASS and name not in PACKAGE_TRACKERS:
            raise ValueError(f"Unknown tracker {name!r}; choose from "
                             f"{sorted([*LOGGER_TYPE_TO_CLASS, *PACKAGE_TRACKERS])}")
        if name in PACKAGE_TRACKERS:
            if not _installed(name):
                logging.getLogger(__name__).warning(
                    "Tracker %s requested but not installed; skipping", name)
                continue
            raise NotImplementedError(f"the {name} tracker is not ported yet (ROADMAP Queue 1, "
                                      "item 33); log_with='jsonl' is")
        cls = LOGGER_TYPE_TO_CLASS[name]
        kwargs = dict(init_kwargs.get(name, {}))
        if cls.requires_logging_directory:
            kwargs.setdefault("logging_dir", logging_dir)
        tracker = cls(project_name, **kwargs)
        if config:
            tracker.store_init_configuration(config)
        trackers.append(tracker)
    return trackers
