"""Native checkpoints (save and resume): the counterpart of
flownet2_tpu/checkpoints/native.py.

A checkpoint is a directory ``<save_dir>/<tag>`` (tags ``train-checkpoint``,
``checkpoint``, ``model_best``) holding ``state.pt``, one ``torch.save`` of
the model's ``state_dict``, the optimizer's state (the inner
``torch.optim`` state and the step count that drives the LR schedule), and
``meta.json`` with ``epoch`` and ``best_EPE``.  It is written beside its
place as ``<tag>.tmp`` and renamed in (``_replace_dir``); a crash between
the two renames leaves the previous checkpoint at ``<tag>.old``, which
``restore_checkpoint`` takes back.  ``model_best`` is a copy of the
checkpoint that improved the best EPE, made of hard links where the file
system allows them (no checkpoint file is written again once it is in
place: a new save renames a new directory in).

Where ``torch.distributed`` is initialised every rank calls both
functions: ``save_checkpoint`` is written by rank 0 alone, and every rank
then meets the others at a barrier, so none goes on before the checkpoint
is in place (the JAX save's barriers); ``restore_checkpoint`` recovers a
``<tag>.old`` on rank 0 alone, meets the others at a barrier, and then
every rank loads the checkpoint onto its own device.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Optional

import torch

from ..parallel import barrier

STATE_FILE = "state.pt"


def is_primary() -> bool:
    """Rank 0 where ``torch.distributed`` is initialised, else True: the
    process that owns the run's files."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _ckpt_dir(base, tag) -> str:
    """``tag=None``: ``base`` IS the checkpoint directory (a resume path
    that names ``<run>/model_best``, say)."""
    return os.fspath(base) if tag is None else os.path.join(
        os.fspath(base), tag)


def resume_location(path: str | os.PathLike):
    """``(directory, tag)`` of the checkpoint that a resume path names: a
    run directory that holds a ``train-checkpoint`` means that one, any
    other path (``<run>/model_best``, a converted checkpoint) is the
    checkpoint directory itself (tag None)."""
    tag = "train-checkpoint"
    if not os.path.isdir(os.path.join(path, tag)):
        tag = None
    return path, tag


def _replace_dir(src: pathlib.Path, dst: pathlib.Path) -> None:
    """Rename-swap ``src`` into place at ``dst``.

    Not one atomic operation: a crash between the two renames leaves the
    previous checkpoint at ``<dst>.old`` and nothing at ``dst``, which
    ``restore_checkpoint`` recovers.  A complete checkpoint, old or new,
    is on disk at every moment."""
    old = dst.with_name(dst.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    if dst.exists():
        dst.rename(old)
    src.rename(dst)
    if old.exists():
        shutil.rmtree(old)


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def save_checkpoint(directory: str | os.PathLike, model: torch.nn.Module,
                    optimizer, epoch: int, best_epe: float,
                    is_best: bool = False,
                    tag: Optional[str] = "train-checkpoint") -> str:
    """Save the model's parameters, ``optimizer``'s state (a
    ``train.optim.Optimizer``, or None for the weights alone) and the
    metadata under ``<directory>/<tag>``; with ``is_best`` also as
    ``<directory>/model_best``.  Returns the checkpoint's path."""
    directory = pathlib.Path(directory)
    path = pathlib.Path(_ckpt_dir(directory, tag)).absolute()
    if is_primary():
        _write(directory, path, model, optimizer, epoch, best_epe, is_best)
    barrier()
    return str(path)


def _write(directory: pathlib.Path, path: pathlib.Path, model, optimizer,
           epoch: int, best_epe: float, is_best: bool) -> None:
    """``save_checkpoint``'s files, written by one process."""
    tmp = path.with_name(path.name + ".tmp")
    path.parent.mkdir(parents=True, exist_ok=True)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    torch.save({"model": model.state_dict(),
                "optimizer": (optimizer.state_dict()
                              if optimizer is not None else None)},
               tmp / STATE_FILE)
    meta = {"epoch": int(epoch), "best_EPE": float(best_epe)}
    (tmp / "meta.json").write_text(json.dumps(meta))
    _replace_dir(tmp, path)
    if is_best:
        best = pathlib.Path(_ckpt_dir(directory, "model_best")).absolute()
        btmp = best.with_name(best.name + ".tmp")
        if btmp.exists():
            shutil.rmtree(btmp)
        shutil.copytree(path, btmp, copy_function=_link_or_copy)
        _replace_dir(btmp, best)


def restore_checkpoint(directory: str | os.PathLike, model: torch.nn.Module,
                       optimizer=None,
                       tag: Optional[str] = "train-checkpoint") -> dict:
    """Restore a checkpoint of ``save_checkpoint`` into ``model`` and, when
    given, ``optimizer`` (bound to the same model's parameters), in place,
    onto the device each parameter lives on; returns the metadata.
    ``tag=None`` takes ``directory`` itself as the checkpoint."""
    path = pathlib.Path(_ckpt_dir(directory, tag)).absolute()
    # a crash inside _replace_dir's rename window parks the previous
    # checkpoint at <tag>.old
    old = path.with_name(path.name + ".old")
    if is_primary() and not path.exists() and old.exists():
        old.rename(path)
    barrier()
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    # the host first: torch.optim keeps Adam's step count on the CPU and
    # moves the moments onto their parameters' device
    state = torch.load(path / STATE_FILE, map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    meta_path = path / "meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}
