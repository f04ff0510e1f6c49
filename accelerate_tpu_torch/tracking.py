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
process only.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import math
import os
import time
from typing import Any

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

    def finish(self) -> None:
        pass


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
