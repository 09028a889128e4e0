"""The host-side training loop.

Port of ``livelyspeaker_tpu/training/loop.py``: epochs over any iterable of
batches, KV logging with loss quartiles every ``log_interval`` steps, the LR
anneal stop, periodic checkpoints with resume (fast-forwarding into the
interrupted epoch), and the params and EMA npz export.

Each step draws from its own generator, seeded from (seed, global step), so
a resumed run replays the draws of an uninterrupted one.

With a ``mesh`` (``parallel.create_mesh``) of more than one shard or with a
model axis above 1, or with ``use_shard_map``, the loop trains through the
data-parallel step of ``parallel/training.py``; ``state`` is shard 0's, the
checkpoint holds that one copy (whole over the model's names: under tensor
parallelism gathered from shard 0's slices), and a resume restores every
replica from it. With ``fsdp`` it
trains through the fully sharded step: ``state`` is shard 0's slices, pinned to their placement
(``parallel.preserve_state_shardings``), a checkpoint holds one gathered
copy, and a resume slices it again. ``backbone_factory`` (the pipeline
stages, ``parallel.pipeline``) runs each shard's mixer stack.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch

from .checkpoints import CheckpointManager, save_args, save_params_npz
from .logging import KVLogger, NoPlatform, TrainPlatform, log_loss_quartiles
from ..utils.device import place_model
from .trainer import TrainConfig, TrainState, init_train_state, make_optimizer, make_train_step

__all__ = ["TrainLoop", "step_generator"]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of global step ``step`` of a run seeded ``seed``."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


class TrainLoop:
    """Trains ``model`` in place. ``params``, when given, is a state_dict
    copied into the model first (so that several loops can start from one
    snapshot); ``data`` is any iterable of batches (see ``make_train_step``).

    The loop runs on the card unless the caller asks otherwise: with
    ``device=None`` the model is moved to ``cuda`` (one already on a CUDA
    device stays there) and construction raises where there is none;
    ``device="cpu"``, or any explicit device, is taken as given.

    ``mesh`` puts the model on its first device and, when its data axis has
    more than one shard or ``use_shard_map`` is set, trains data-parallel
    over it (``parallel.shard_train_step``); ``device`` must then be None.
    The data may then yield the global batch or a list of one batch a
    shard (``DataLoader(mesh=...)``). ``fsdp`` (with a mesh) trains the
    fully sharded step (``parallel.fsdp_train_step``) instead. ``backbone_factory``: see
    ``training.trainer.make_loss_fn``; refused with ``use_shard_map``, as in
    the JAX loop."""

    def __init__(
        self,
        model,
        sched,
        params: Optional[Mapping[str, torch.Tensor]],
        data: Iterable,
        *,
        cfg: Optional[TrainConfig] = None,
        save_dir: Optional[str] = None,
        num_epochs: int = 1501,
        log_interval: int = 100,
        save_after_epoch: int = 600,
        save_every_epochs: int = 100,
        platform: Optional[TrainPlatform] = None,
        seed: int = 233,
        args_to_save: Optional[Dict] = None,
        resume: bool = False,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
        use_shard_map: bool = False,
        backbone_factory=None,
        fsdp: bool = False,
    ):
        if use_shard_map and mesh is None:
            raise ValueError("use_shard_map=True requires a mesh")
        if fsdp and mesh is None:
            raise ValueError("fsdp=True requires a mesh")
        if use_shard_map and backbone_factory is not None:
            raise ValueError(
                "backbone_factory (pipeline parallelism) and "
                "use_shard_map (fused-kernel DP) are separate mesh "
                "programs; drop one"
            )
        if mesh is not None:
            if device is not None:
                raise ValueError("TrainLoop takes a mesh or a device, not both")
            device = mesh.devices[0]
        self.device = place_model(model, device, "TrainLoop")
        self.mesh = mesh
        self.model = model.train()
        self.sched = sched
        self.data = data
        self.cfg = cfg or TrainConfig()
        self.num_epochs = num_epochs
        self.log_interval = log_interval
        self.save_after_epoch = save_after_epoch
        self.save_every_epochs = save_every_epochs
        self.save_dir = save_dir
        self.logger = KVLogger(save_dir)
        self.platform = platform or NoPlatform(save_dir or ".")
        self.seed = seed

        if params is not None:
            model.load_state_dict(params)
        tx = make_optimizer(self.cfg)
        self.state: TrainState = init_train_state(
            dict(model.named_parameters()), tx, cfg=self.cfg,
            num_timesteps=sched.num_timesteps)
        self.fsdp = fsdp
        # the step's state is slices: a checkpoint gathers one whole copy
        self._gathered = fsdp or (mesh is not None and mesh.shape.get("model", 1) > 1)
        if fsdp:
            from ..parallel.training import fsdp_train_step

            self.step_fn = fsdp_train_step(model, sched, tx, self.cfg, mesh,
                                           backbone_factory=backbone_factory)
        elif mesh is not None and (use_shard_map or mesh.shape["data"] > 1
                                   or mesh.shape.get("model", 1) > 1):
            from ..parallel.training import shard_train_step

            self.step_fn = shard_train_step(model, sched, tx, self.cfg, mesh,
                                            backbone_factory=backbone_factory)
        else:
            step = make_train_step(model, sched, tx, self.cfg, backbone_factory=backbone_factory)
            # a mesh of one shard: the loaders yield a list of one batch
            self.step_fn = step if mesh is None else (
                lambda st, batch, gen: step(st, batch[0] if isinstance(batch, (list, tuple))
                                            else batch, gen))
        self.ckpt = CheckpointManager(save_dir) if save_dir else None
        self.start_step = 0
        if save_dir and args_to_save is not None:
            save_args(save_dir, args_to_save)
        if resume and self.ckpt is not None:
            restored, step = self.ckpt.restore(self.state)
            if restored is not None:
                self.state = restored
                self.start_step = step
                print(f"resumed from step {step}")
        if fsdp:  # slice the full state over the shards, then pin the slices
            from ..parallel.mesh import preserve_state_shardings

            self.state = self.step_fn.shard(self.state)
            self.step_fn = preserve_state_shardings(self.step_fn, self.state)
        self.host_step = self.start_step

    @property
    def step(self) -> int:
        return self.host_step

    def _anneal_done(self) -> bool:
        return bool(self.cfg.lr_anneal_steps and self.host_step >= self.cfg.lr_anneal_steps)

    def run_loop(self) -> TrainState:
        t_start = time.time()
        # resume: re-enter the epoch and batch the run stopped at (needs a
        # sized, epoch-seeded loader; a plain iterable just restarts)
        start_epoch, skip = 0, 0
        steps_per_epoch = len(self.data) if hasattr(self.data, "__len__") else 0
        if self.start_step and steps_per_epoch:
            start_epoch = self.start_step // steps_per_epoch
            skip = self.start_step % steps_per_epoch
        for epoch in range(start_epoch, self.num_epochs):
            if hasattr(self.data, "set_epoch"):
                try:
                    self.data.set_epoch(epoch, start_batch=skip)
                    skip = 0
                except TypeError:  # set_epoch(epoch) only
                    self.data.set_epoch(epoch)
            for batch in self.data:
                if skip:
                    skip -= 1
                    continue
                if self._anneal_done():
                    break
                gen = step_generator(self.seed, self.host_step, self.device)
                self.state, metrics = self.step_fn(self.state, batch, gen)
                self.host_step += 1
                if self.host_step % self.log_interval == 0:
                    self._log(metrics, batch, t_start)
            if (self.ckpt is not None and epoch % self.save_every_epochs == 0
                    and epoch > self.save_after_epoch):
                self.save()
            if self._anneal_done():
                break
        if self.ckpt is not None:
            self.save()
        return self.state

    def _log(self, metrics, batch, t_start) -> None:
        t = metrics.pop("t").cpu().numpy()
        loss_ps = metrics.pop("loss_per_sample").cpu().numpy()
        log_loss_quartiles(self.logger, t, {"loss": loss_ps},
                           self.sched.num_timesteps, log_means=False)
        for k, v in metrics.items():
            self.logger.logkv_mean(k, v)
        self.logger.logkv("step", self.step)
        shards = batch if isinstance(batch, (list, tuple)) else [batch]
        self.logger.logkv("samples", self.step * sum(b["motion"].shape[0] for b in shards))
        self.logger.logkv("elapsed_s", time.time() - t_start)
        for k, v in self.logger.dumpkvs().items():
            self.platform.report_scalar(name=k, value=v, iteration=self.step,
                                        group_name="Loss")

    def save(self) -> None:
        """Checkpoint and npz export at this step: one full copy (gathered
        from the shards under FSDP or tensor parallelism)."""
        if self.ckpt.latest_step() == self.step:
            return  # already saved at this step
        state = self.step_fn.gathered_state() if self._gathered else self.state
        self.ckpt.save(self.step, state)
        save_params_npz(f"{self.save_dir}/model{self.step:09d}.npz", state.params, self.model)
        if state.ema_params is not None:
            save_params_npz(f"{self.save_dir}/model_ema{self.step:09d}.npz",
                            state.ema_params, self.model)
        print(f"saved checkpoint at step {self.step}")
