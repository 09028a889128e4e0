"""RAG sampling, the user-facing generation API of the port.

Port of ``RAGSampler`` from ``livelyspeaker_tpu/pipeline.py``: audio- and
speaker-conditioned gesture sampling with classifier-free guidance. The
weights live in the model; :meth:`RAGSampler.update_params` swaps them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from .diffusion.sampling import sample_loop
from .diffusion.schedule import DiffusionSchedule
from .models.cfg import make_cfg_denoiser, make_guidance_schedule
from .models.fast_rag import make_fused_cfg_denoiser
from .models.rag import RAG
from .utils.device import place_model

__all__ = ["RAGSampler"]


class RAGSampler:
    """CFG sampling of a :class:`RAG`, on the card unless the caller asks
    otherwise: with ``device=None`` the model is moved to ``cuda`` (one
    already on a CUDA device stays there) and construction raises where
    there is none; ``device="cpu"``, or any explicit device, is taken as
    given, and on the CPU the fused path runs its plain PyTorch version.

    ``use_fused=True`` runs each denoise step through the fused TransMLP
    kernel (``models/fast_rag.py``); ``False`` runs the eager modules.

    Construction pins ``torch.backends.cudnn.allow_tf32 = False`` for the
    process: cuDNN's default runs the f32 WavEncoder convs in TF32 (about
    three decimal digits), and the port computes in f32 throughout."""

    def __init__(
        self,
        model: RAG,
        *,
        steps: int = 1000,
        schedule: str = "cosine",
        timestep_respacing: Optional[str] = "ddim100",
        method: str = "ddim",
        use_fused: bool = False,
        guidance_schedule: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        torch.backends.cudnn.allow_tf32 = False
        self.device = place_model(model, device, "RAGSampler")
        self.model = model.eval()
        self.method = method
        self.use_fused = use_fused
        self.guidance_schedule = guidance_schedule
        sched = DiffusionSchedule.create(
            steps=steps, schedule=schedule, timestep_respacing=timestep_respacing
        )
        self._timestep_map = sched.timestep_map.tolist()  # host copy, no sync
        self.sched = sched.to(self.device)

    def _guidance_schedule_fn(self, skip_timesteps: int):
        """Schedule normalised to the executed window: its boundary is the
        original-process timestep of the first reverse step that runs."""
        idx = self.sched.num_timesteps - int(skip_timesteps) - 1
        if not 0 <= idx < self.sched.num_timesteps:
            raise ValueError(f"skip_timesteps {skip_timesteps} out of range")
        t_boundary = self._timestep_map[idx]
        return make_guidance_schedule(self.guidance_schedule, t_boundary)

    @torch.no_grad()
    def update_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Hot-swap the model weights (serving checkpoint reload).

        Names, shapes and dtypes are validated before anything is copied, so
        a wrong checkpoint fails this call and leaves the weights as they
        were. The copy is enqueued on the current stream, behind every batch
        dispatched before it."""
        own = self.model.state_dict()
        if set(state_dict) != set(own):
            missing = sorted(set(own) - set(state_dict))
            extra = sorted(set(state_dict) - set(own))
            raise ValueError(
                "checkpoint param tree differs from the serving model's: "
                f"missing {missing[:5]}, unexpected {extra[:5]}"
            )
        bad = [k for k, v in state_dict.items()
               if tuple(v.shape) != tuple(own[k].shape) or v.dtype != own[k].dtype]
        if bad:
            raise ValueError(f"checkpoint leaf shape/dtype mismatch at: {', '.join(bad)}")
        self.model.load_state_dict(state_dict)

    @torch.no_grad()
    def __call__(
        self,
        cond: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        *,
        guidance=1.5,
        skip_timesteps: int = 0,
        init_image: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sample clips [B, J, F, T] for the conditioning in ``cond`` (on the
        model's device); ``guidance`` is a scalar or a per-sample [B]."""
        c = self.model.cfg
        b = cond["vid"].shape[0]
        gsched = self._guidance_schedule_fn(skip_timesteps)
        make = make_fused_cfg_denoiser if self.use_fused else make_cfg_denoiser
        denoise = make(self.model, cond, guidance, guidance_schedule=gsched)
        return sample_loop(
            denoise,
            self.sched,
            (b, c.njoints, c.nfeats, c.nframes),
            generator,
            method=self.method,
            skip_timesteps=skip_timesteps,
            init_image=init_image,
        )
