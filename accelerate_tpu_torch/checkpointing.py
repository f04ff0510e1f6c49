"""Checkpoints of a training run and model exports: the port of
`accelerate_tpu.checkpointing` at one process.

``save_state`` writes every prepared object into one directory (reference
`checkpointing.py:249-509`): each model's fp32 master weights as
``model_<i>.safetensors``, each optimizer (its torch state, its update
counts and the fp16 scaler's state), scheduler and data loader as
``optimizer_<i>.bin`` (the torch state) with ``optimizer_<i>.meta.pkl`` (the
counts and the scaler), ``scheduler_<i>.bin`` and ``dataloader_<i>.bin``
(`torch.save`), each registered custom object as
``custom_checkpoint_<i>.pkl``, the RNG state as ``rng_state.pkl`` and the
accelerator's step as ``step.pkl``; then, last, the ``_COMPLETE`` marker.
Every file is written and read in the reference's order, each under
`CHECKPOINT_RETRY_POLICY` (3 attempts on ``OSError``) with a fault point
(`reliability.faults.SCOPE_CHECKPOINT_SAVE` / ``_RESTORE``) inside each
attempt, so a transient I/O error costs a retry and a seeded
`FaultInjector` fires at the same files in both packages.
A directory without it is a torn save, and ``load_state(None)`` walks the
complete ``checkpoints/checkpoint_<n>`` directories newest first until one
loads. With ``ProjectConfiguration(automatic_checkpoint_naming=True)`` each
save takes the next ``checkpoint_<n>`` and ``total_limit`` prunes the oldest.
``async_save`` copies every tensor to host memory before it returns and
writes the files on a thread; the marker lands when the thread has written
everything, and ``wait_for_checkpoint`` (called before every later save and
load) joins it and raises what it raised.

The reference writes its arrays with orbax, which needs JAX: the port
neither reads nor writes orbax directories, so a checkpoint of one package
does not resume the other. Model exports are shared: `save_model_weights`
writes safetensors under the reference's parameter names when the model
knows them (``reference_state_dict``), and `load_model_weights` reads the
reference's exports. The `.bin` and `.pkl` files are pickles: load only
checkpoints this program wrote.
"""

from __future__ import annotations

import os
import pickle
import shutil
import threading
import warnings
from pathlib import Path
from typing import Any

import torch

from .reliability.faults import SCOPE_CHECKPOINT_RESTORE, SCOPE_CHECKPOINT_SAVE, fault_point
from .reliability.retry import RetryPolicy
from .utils.constants import (
    CHECKPOINT_COMPLETE_MARKER,
    CHECKPOINT_DIR_PREFIX,
    CUSTOM_STATE_NAME,
    DATALOADER_STATE_NAME,
    MODEL_NAME,
    OPTIMIZER_NAME,
    RNG_STATE_NAME,
    SCHEDULER_NAME,
    STEP_STATE_NAME,
)
from .utils.operations import recursively_apply
from .utils.random import capture_rng_state, restore_rng_state
from .utils.safetensors_io import (
    load_file,
    load_safetensors_checkpoint,
    save_file,
    save_safetensors_checkpoint,
)

# the reference's policy for every checkpoint write and read; module-level,
# so a deployment may swap in its own
CHECKPOINT_RETRY_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
                                      retryable=(OSError,))


class CheckpointSaveError(Exception):
    """More than one async save failed; ``errors`` holds each failure."""

    def __init__(self, errors: list[BaseException]):
        super().__init__(f"{len(errors)} async checkpoint writer(s) failed: "
                         + "; ".join(repr(e) for e in errors))
        self.errors = errors


class CheckpointRestoreError(Exception):
    """Every complete checkpoint failed to load; ``errors`` holds the
    failures, newest checkpoint first."""

    def __init__(self, errors: list[BaseException]):
        super().__init__(f"all {len(errors)} complete checkpoint(s) failed to restore: "
                         + "; ".join(repr(e) for e in errors))
        self.errors = errors


class _PendingSave:
    """One async save: a thread writing ``files`` (name -> what to write)
    into ``directory``, then the marker."""

    def __init__(self, directory: Path, files: dict[str, Any]):
        self.directory = directory
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, args=(files,),
                                       name=f"checkpoint-save-{directory.name}")
        self.thread.start()  # not a daemon: the interpreter waits for it at exit

    def _run(self, files: dict[str, Any]) -> None:
        try:
            _write_all(self.directory, files)
        except Exception as exc:  # kept for wait_for_checkpoint_saves to raise
            self.error = exc


def _write(path: Path, obj: Any) -> None:
    """One file, retried on a transient ``OSError``."""

    def attempt() -> None:
        fault_point(SCOPE_CHECKPOINT_SAVE)
        if path.suffix == ".safetensors":
            save_file(obj, path)
        elif path.suffix == ".bin":
            torch.save(obj, path)
        else:
            with open(path, "wb") as f:
                pickle.dump(obj, f)

    CHECKPOINT_RETRY_POLICY.call(attempt)


def _read(path: Path) -> Any:
    """One file, retried on a transient ``OSError`` (a missing file is not
    retried)."""

    def attempt() -> Any:
        fault_point(SCOPE_CHECKPOINT_RESTORE)
        if path.suffix == ".safetensors":
            return load_file(path)
        if path.suffix == ".bin":
            return torch.load(path, map_location="cpu", weights_only=False)
        with open(path, "rb") as f:
            return pickle.load(f)

    return CHECKPOINT_RETRY_POLICY.call(attempt)


def _write_all(directory: Path, files: dict[str, Any]) -> None:
    """Every file in order, then the marker."""
    for name, obj in files.items():
        _write(directory / name, obj)
    (directory / CHECKPOINT_COMPLETE_MARKER).write_text("complete\n")


def _to_host(obj: Any) -> Any:
    """Every tensor leaf copied to host memory, so a write that runs later
    sees the values of now."""
    return recursively_apply(lambda t: t.detach().to("cpu", copy=True), obj)


def wait_for_checkpoint_saves(accelerator) -> None:
    """Join every async save ``accelerator`` started; raise what failed (the
    failed directories keep no marker)."""
    errors = []
    while accelerator._pending_saves:
        job = accelerator._pending_saves.pop(0)
        job.thread.join()
        if job.error is not None:
            errors.append(job.error)
    if len(errors) == 1:
        raise errors[0]
    if errors:
        raise CheckpointSaveError(errors)


def _checkpoint_dirs(base: Path) -> list[Path]:
    """``base``'s ``checkpoint_<n>`` directories, by n."""
    if not base.exists():
        return []
    found = [d for d in base.iterdir()
             if d.name.startswith(CHECKPOINT_DIR_PREFIX + "_") and d.name.rsplit("_", 1)[1].isdigit()]
    return sorted(found, key=lambda d: int(d.name.rsplit("_", 1)[1]))


def _base(accelerator) -> Path:
    return Path(accelerator.project_configuration.project_dir or ".") / "checkpoints"


def get_checkpoint_dir(accelerator, output_dir: str | os.PathLike | None) -> Path:
    """Where ``save_state`` writes: ``output_dir``, else
    ``<project_dir>/checkpoints``, or with automatic naming its next
    ``checkpoint_<iteration>``, after pruning the oldest past
    ``total_limit``."""
    pc = accelerator.project_configuration
    if output_dir is not None:
        return Path(output_dir)
    base = _base(accelerator)
    base.mkdir(parents=True, exist_ok=True)
    if not pc.automatic_checkpoint_naming:
        return base
    existing = _checkpoint_dirs(base)
    if pc.total_limit is not None and len(existing) + 1 > pc.total_limit:
        for stale in existing[:len(existing) + 1 - pc.total_limit]:
            shutil.rmtree(stale, ignore_errors=True)
    target = base / f"{CHECKPOINT_DIR_PREFIX}_{pc.iteration}"
    pc.iteration += 1
    return target


def complete_checkpoint_dirs(accelerator) -> list[Path]:
    """Every automatic checkpoint directory that holds the marker, newest
    first."""
    wait_for_checkpoint_saves(accelerator)
    dirs = [d for d in _checkpoint_dirs(_base(accelerator))
            if (d / CHECKPOINT_COMPLETE_MARKER).exists()]
    return dirs[::-1]


def latest_checkpoint_dir(accelerator) -> Path:
    candidates = complete_checkpoint_dirs(accelerator)
    if not candidates:
        raise FileNotFoundError(f"No complete checkpoints under {_base(accelerator)}")
    return candidates[0]


def save_accelerator_state(accelerator, output_dir: str | os.PathLike,
                           weights: list[dict[str, torch.Tensor]] | None = None,
                           async_save: bool = False) -> str:
    """Write every prepared object's state into ``output_dir`` (see the
    module docstring). ``weights`` (from the save pre-hooks) replaces each
    model's state dict in what is written. Returns the directory."""
    wait_for_checkpoint_saves(accelerator)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / CHECKPOINT_COMPLETE_MARKER).unlink(missing_ok=True)
    files: dict[str, Any] = {}
    for i, model in enumerate(accelerator._models):
        sd = weights[i] if weights is not None else model.module.state_dict()
        files[f"{MODEL_NAME}_{i}.safetensors"] = sd
    for i, opt in enumerate(accelerator._optimizers):
        sd = opt.state_dict()
        files[f"{OPTIMIZER_NAME}_{i}.bin"] = sd.pop("optimizer")
        files[f"{OPTIMIZER_NAME}_{i}.meta.pkl"] = sd
    for i, sched in enumerate(accelerator._schedulers):
        files[f"{SCHEDULER_NAME}_{i}.bin"] = sched.state_dict()
    for i, dl in enumerate(accelerator._dataloaders):
        files[f"{DATALOADER_STATE_NAME}_{i}.bin"] = dl.state_dict()
    for i, obj in enumerate(accelerator._custom_objects):
        files[f"{CUSTOM_STATE_NAME}_{i}.pkl"] = obj.state_dict()
    files[f"{RNG_STATE_NAME}.pkl"] = capture_rng_state()
    files[f"{STEP_STATE_NAME}.pkl"] = {"step": accelerator.step}
    files = _to_host(files)
    if async_save:
        accelerator._pending_saves.append(_PendingSave(out, files))
    else:
        _write_all(out, files)
    return str(out)


def load_accelerator_state(accelerator, input_dir: str | os.PathLike | None = None) -> str:
    """Load every prepared object from ``input_dir``, or with None from the
    newest complete automatic checkpoint that loads (a warning for each that
    does not; `CheckpointRestoreError` when none does). Returns the
    directory loaded."""
    wait_for_checkpoint_saves(accelerator)
    if input_dir is not None:
        return _load_from(accelerator, Path(input_dir))
    candidates = complete_checkpoint_dirs(accelerator)
    if not candidates:
        raise FileNotFoundError(f"No complete checkpoints under {_base(accelerator)}")
    failures: list[BaseException] = []
    for candidate in candidates:
        try:
            return _load_from(accelerator, candidate)
        except Exception as exc:  # a corrupt or unreadable checkpoint: try the one before
            failures.append(exc)
            warnings.warn(f"checkpoint {candidate} failed to restore ({exc!r}); falling back to "
                          "the previous complete checkpoint", stacklevel=2)
    raise CheckpointRestoreError(failures)


def _load_from(accelerator, src: Path) -> str:
    # read everything, in the reference's order, before changing anything: a
    # corrupt file leaves the run as it was
    def take(name: str, required: bool = True) -> Any:
        path = src / name
        if not path.is_file():
            if required:
                raise FileNotFoundError(f"{path} is missing")
            return None
        return _read(path)

    models = [take(f"{MODEL_NAME}_{i}.safetensors") for i in range(len(accelerator._models))]
    optimizers = [{"optimizer": take(f"{OPTIMIZER_NAME}_{i}.bin"),
                   **(take(f"{OPTIMIZER_NAME}_{i}.meta.pkl", required=False) or {})}
                  for i in range(len(accelerator._optimizers))]
    schedulers = [take(f"{SCHEDULER_NAME}_{i}.bin") for i in range(len(accelerator._schedulers))]
    loaders = [take(f"{DATALOADER_STATE_NAME}_{i}.bin")
               for i in range(len(accelerator._dataloaders))]
    customs = [take(f"{CUSTOM_STATE_NAME}_{i}.pkl")
               for i in range(len(accelerator._custom_objects))]
    rng = take(f"{RNG_STATE_NAME}.pkl", required=False)
    step = take(f"{STEP_STATE_NAME}.pkl", required=False)
    for model, sd in zip(accelerator._models, models):
        model.module.load_state_dict(sd)
    for opt, sd in zip(accelerator._optimizers, optimizers):
        opt.load_state_dict(sd)
    for sched, sd in zip(accelerator._schedulers, schedulers):
        sched.load_state_dict(sd)
    for dl, sd in zip(accelerator._dataloaders, loaders):
        dl.load_state_dict(sd)
    for obj, sd in zip(accelerator._custom_objects, customs):
        obj.load_state_dict(sd)
    if rng is not None:
        restore_rng_state(rng)
    if step is not None:
        accelerator.step = step["step"]
    return str(src)


def save_custom_state(obj: Any, path: str | os.PathLike, index: int = 0) -> str:
    """Write one custom object's ``state_dict()`` as
    ``custom_checkpoint_<index>.pkl`` (reference `checkpointing.py:470`)."""
    target = Path(path) / f"{CUSTOM_STATE_NAME}_{index}.pkl"
    _write(target, _to_host(obj.state_dict()))
    return str(target)


def load_custom_state(obj: Any, path: str | os.PathLike, index: int = 0) -> None:
    obj.load_state_dict(_read(Path(path) / f"{CUSTOM_STATE_NAME}_{index}.pkl"))


def save_model_weights(state_dict: dict[str, Any], save_directory: str | os.PathLike,
                       max_shard_size: str | int = "10GB",
                       safe_serialization: bool = True) -> list[str]:
    """A consolidated export (reference `checkpointing.py:479`): safetensors,
    sharded past ``max_shard_size`` with a ``model.safetensors.index.json``,
    tied tensors written once. ``state_dict`` may be nested; its dotted keys
    are the names written. ``safe_serialization=False`` asks for flax's
    msgpack, which the port does not write."""
    if not safe_serialization:
        raise ValueError("safe_serialization=False asks for flax's msgpack serialization, which "
                         "the PyTorch port does not write; export safetensors")
    os.makedirs(save_directory, exist_ok=True)
    return save_safetensors_checkpoint(_to_host(state_dict), save_directory,
                                       max_shard_size=max_shard_size)


def load_model_weights(save_directory: str | os.PathLike) -> dict[str, Any]:
    """The weights of a consolidated export as nested dicts of CPU tensors
    (the dotted safetensors keys unflattened, as the reference returns
    them). Raises ValueError for a ``model.msgpack`` export."""
    directory = Path(save_directory)
    if (directory / "model.msgpack").exists():
        raise ValueError(
            f"{directory / 'model.msgpack'} is flax's msgpack serialization, which the PyTorch "
            "port does not read; export with safe_serialization=True (safetensors)"
        )
    return load_safetensors_checkpoint(directory, nested=True)
