"""Checkpoints of the training state, run metadata, and the portable params
file.

Port of ``livelyspeaker_tpu/training/checkpoints.py``: ``args.json`` beside
the checkpoints, a manager that saves and restores the whole
:class:`TrainState` by step (``torch.save``, one file a step, written
atomically), and :func:`save_params_npz`, which writes the JAX tree's flat
keys and layouts so that the JAX package's ``load_params_npz`` reads a model
trained here.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..diffusion.resample import LossSecondMomentState
from ..utils.checkpoints import load_params_npz
from ..utils.convert import flatten_tree, state_dict_to_jax_params
from .trainer import AdamWState, TrainState

__all__ = ["CheckpointManager", "save_args", "load_args", "save_params_npz",
           "load_params_npz"]


def save_args(save_dir: str, args: Dict[str, Any]) -> None:
    """Write the run's hyperparameters to ``save_dir/args.json``."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "args.json"), "w") as f:
        json.dump(args, f, indent=2, sort_keys=True, default=str)


def load_args(model_path_or_dir: str) -> Dict[str, Any]:
    """The ``args.json`` in a run directory, or beside a checkpoint file."""
    d = model_path_or_dir
    if not os.path.isdir(d):
        d = os.path.dirname(d)
    with open(os.path.join(d, "args.json")) as f:
        return json.load(f)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """Whole train states by step, as ``ckpt_{step:09d}.pt`` in save_dir."""

    _NAME = re.compile(r"^ckpt_(\d{9})\.pt$")

    def __init__(self, save_dir: str, max_to_keep: Optional[int] = None):
        self.save_dir = os.path.abspath(save_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.save_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.save_dir, f"ckpt_{step:09d}.pt")

    def steps(self):
        found = (self._NAME.match(n) for n in os.listdir(self.save_dir))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        sampler = state.sampler_state
        blob = {
            "step": state.step,
            "params": _to_cpu(state.params),
            "opt_state": {"count": state.opt_state.count,
                          "mu": _to_cpu(state.opt_state.mu),
                          "nu": _to_cpu(state.opt_state.nu)},
            "sampler_state": None if sampler is None else {
                "history": sampler.history, "counts": sampler.counts,
                "uniform_prob": sampler.uniform_prob},
            "ema_params": None if state.ema_params is None else _to_cpu(state.ema_params),
        }
        tmp = self._path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                os.unlink(self._path(old))

    def restore(self, state_template: TrainState,
                step: Optional[int] = None) -> Tuple[Optional[TrainState], int]:
        """(state, step) of the checkpoint at ``step`` (default the latest),
        or (None, 0) when there is none. The params are copied into the
        template's tensors (the model's own) and the rest is placed on
        their devices."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, 0
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        like = lambda saved, ref: {k: saved[k].to(ref[k].device) for k in ref}
        with torch.no_grad():
            for k, p in state_template.params.items():
                p.copy_(blob["params"][k])
        opt = blob["opt_state"]
        tmpl_opt = state_template.opt_state
        sampler = blob["sampler_state"]
        ema = blob["ema_params"]
        return TrainState(
            step=int(blob["step"]),
            params=state_template.params,
            opt_state=AdamWState(count=int(opt["count"]), mu=like(opt["mu"], tmpl_opt.mu),
                                 nu=like(opt["nu"], tmpl_opt.nu)),
            sampler_state=None if sampler is None else LossSecondMomentState(
                history=sampler["history"], counts=sampler["counts"],
                uniform_prob=float(sampler["uniform_prob"])),
            ema_params=None if ema is None else like(ema, state_template.params),
        ), step


def save_params_npz(path: str, params: Mapping[str, torch.Tensor], model: nn.Module) -> None:
    """Write ``params`` (state_dict keys of ``model``: its parameters, or an
    EMA of them) as the JAX package's flat ``{'a/b/c': array}`` npz."""
    np.savez(path, **flatten_tree(state_dict_to_jax_params(params, model)))
