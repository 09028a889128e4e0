"""The user-facing generation API of the port.

Port of ``RAGSampler`` and ``LivelySpeakerPipeline`` from
``livelyspeaker_tpu/pipeline.py``. ``RAGSampler`` is audio- and
speaker-conditioned gesture sampling with classifier-free guidance; the
weights live in the model and :meth:`RAGSampler.update_params` swaps them.
``LivelySpeakerPipeline`` is the two-stage composition: the SAG decodes a
motion sketch from a text feature (CLIP's text tower, or a language model's,
``models/moe_text.py``), and the RAG refines it, q-sampled to step T -
``skip_timesteps`` of the respaced chain, under CFG.
:func:`generate_long_form` and :func:`generate_long_form_stream` chain
windows over audio of any length through either.

Both take a ``mesh`` (``parallel.create_mesh``), as the JAX classes do: the
batch is split over its shards, each of which runs the whole chain on a
replica of the models with its own folded generator
(``parallel/sampling.py``), and the clips come back in order on shard 0's
device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .diffusion.sampling import Inpainting, sample_loop
from .diffusion.schedule import DiffusionSchedule
from .models.cfg import make_cfg_denoiser, make_guidance_schedule
from .models.clip_text import CLIPTextEncoder
from .models.fast_rag import make_fused_cfg_denoiser
from .models.moe_text import MoETextEncoder
from .models.rag import RAG
from .models.sag import SAG
from .parallel.mesh import check_divisible, replicate_module, shard_params, sync_replicas
from .parallel.sampling import shard_sample_fn
from .utils.device import place_model
from .utils.profiling import annotate

__all__ = ["RAGSampler", "LivelySpeakerPipeline", "generate_long_form",
           "generate_long_form_stream", "long_form_window_grid"]


class RAGSampler:
    """CFG sampling of a :class:`RAG`, on the card unless the caller asks
    otherwise: with ``device=None`` the model is moved to ``cuda`` (one
    already on a CUDA device stays there) and construction raises where
    there is none; ``device="cpu"``, or any explicit device, is taken as
    given, and on the CPU the fused path runs its plain PyTorch version.

    ``use_fused=True`` runs each denoise step through the fused TransMLP
    kernel (``models/fast_rag.py``); ``False`` runs the eager modules.

    ``mesh`` splits every batch over the mesh's shards (its data rows; the
    batch must divide their number): each shard samples its rows on its own
    replica of the model with ``fold_in(generator, shard)``, so the draws
    differ from an unsharded call's (same law). On a model axis above 1 a
    replica is tensor-parallel over its row's model group
    (``parallel.shard_params``), and ``use_fused`` raises, as in the JAX
    package. ``device`` must then be None; the model goes to the mesh's
    first device and stays whole there (:meth:`update_params` loads it and
    re-slices every replica from it).

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
        mesh=None,
    ):
        torch.backends.cudnn.allow_tf32 = False
        if mesh is not None:
            if device is not None:
                raise ValueError("RAGSampler takes a mesh or a device, not both")
            device = mesh.devices[0]
        self.device = place_model(model, device, "RAGSampler")
        self.model = model.eval()
        self.mesh = mesh
        self.method = method
        self.use_fused = use_fused
        self.guidance_schedule = guidance_schedule
        sched = DiffusionSchedule.create(
            steps=steps, schedule=schedule, timestep_respacing=timestep_respacing
        )
        self._timestep_map = sched.timestep_map.tolist()  # host copy, no sync
        self.sched = sched.to(self.device)
        if mesh is not None:
            self.replicas = shard_params(self.model, mesh)
            scheds = {d: sched.to(d) for d in dict.fromkeys(mesh.devices)}
            # args: cond, guidance, generator, init_image, inpainting, noise
            self._sharded = shard_sample_fn(
                lambda m, *a, **kw: self._chain(m[0], scheds[m[1]], *a, **kw), mesh,
                list(zip(self.replicas, mesh.devices)),
                batched=(True, True, False, True, True, True), rng_arg=2, fused=use_fused)

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
        if self.mesh is not None:
            sync_replicas(self.replicas, self.model)

    def _chain(self, model, sched, cond, guidance, generator, init_image, inpainting, noise,
               *, skip_timesteps, gsched):
        c = model.cfg
        make = make_fused_cfg_denoiser if self.use_fused else make_cfg_denoiser
        with annotate("rag.prepare"):
            denoise = make(model, cond, guidance, guidance_schedule=gsched)
        return sample_loop(
            denoise,
            sched,
            (cond["vid"].shape[0], c.njoints, c.nfeats, c.nframes),
            generator,
            method=self.method,
            skip_timesteps=skip_timesteps,
            init_image=init_image,
            inpainting=inpainting,
            noise=noise,
        )

    @annotate("rag.sample")
    @torch.no_grad()
    def __call__(
        self,
        cond: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        *,
        guidance=1.5,
        skip_timesteps: int = 0,
        init_image: Optional[torch.Tensor] = None,
        inpainting: Optional[Inpainting] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sample clips [B, J, F, T] for the conditioning in ``cond`` (on the
        model's device); ``guidance`` is a scalar or a per-sample [B].
        ``inpainting`` (its tensors on the model's device) holds frames to a
        constraint at every step; ``noise`` [B, J, F, T] replaces the
        initial draw."""
        gsched = self._guidance_schedule_fn(skip_timesteps)
        args = (cond, guidance, generator, init_image, inpainting, noise)
        if self.mesh is None:
            return self._chain(self.model, self.sched, *args, skip_timesteps=skip_timesteps,
                               gsched=gsched)
        b = cond["vid"].shape[0]
        check_divisible(b, self.mesh)
        if inpainting is not None:  # a broadcast mask or motion: one row each
            c = self.model.cfg
            full = (b, c.njoints, c.nfeats, c.nframes)
            inpainting = inpainting._replace(mask=inpainting.mask.expand(full),
                                             motion=inpainting.motion.expand(full))
        args = (cond, guidance, generator, init_image, inpainting, noise)
        return self._sharded(*args, skip_timesteps=skip_timesteps, gsched=gsched)


class LivelySpeakerPipeline:
    """text + audio + speaker -> gesture clip: the SAG sketch, refined by
    the RAG.

    ``device=None`` puts the three models on the card (construction raises
    without one); ``device="cpu"``, or any explicit device, is taken as
    given, as in :class:`RAGSampler`, which this holds. The weights live in
    the modules; both stages run in ``eval()`` under ``torch.no_grad()``.
    ``use_fused=True`` runs each refinement step through the fused TransMLP
    kernel. ``tokenizer`` maps a list of sentences to int ids [B, 77]
    (``data.clip_tokenizer``). ``clip_text`` may instead be a language
    model's tower (:class:`models.moe_text.MoETextEncoder`); ``tokenizer``
    then maps the sentences to (ids padded to the batch's longest [B, L],
    lengths [B]), on the host. ``mesh`` splits the batch over its shards
    for every stage: the CLIP encode and the SAG decode on each shard's
    whole replicas (on its row's first device, as the JAX class keeps them
    replicated), and the refinement through the sharded
    :class:`RAGSampler`, tensor-parallel on a model axis above 1 (``device``
    must then be None). A language model's tower is too large to
    replicate: with a mesh it is refused."""

    def __init__(
        self,
        rag: RAG,
        sag: SAG,
        clip_text: CLIPTextEncoder,
        tokenizer,
        *,
        steps: int = 1000,
        timestep_respacing: Optional[str] = "ddim100",
        skip_timesteps: int = 80,
        method: str = "ddim",
        guidance_schedule: Optional[str] = None,
        use_fused: bool = False,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
    ):
        if mesh is not None:
            if device is not None:
                raise ValueError("LivelySpeakerPipeline takes a mesh or a device, not both")
            if isinstance(clip_text, MoETextEncoder):
                raise ValueError("a sharded sketch holds the text tower on every shard, and a "
                                 "language model's tower is not replicated: run "
                                 "MoETextEncoder's composition without a mesh")
            device = mesh.devices[0]
        self.device = place_model(sag, device, "LivelySpeakerPipeline")
        self.mesh = mesh
        self.rag_sampler = RAGSampler(
            rag,
            steps=steps,
            timestep_respacing=timestep_respacing,
            method=method,
            use_fused=use_fused,
            guidance_schedule=guidance_schedule,
            device=None if mesh is not None else self.device,
            mesh=mesh,
        )
        self.sag = sag.eval()
        self.lm = isinstance(clip_text, MoETextEncoder)
        self.clip_text = clip_text.to(self.device).eval()
        self.tokenizer = tokenizer
        self.skip_timesteps = skip_timesteps
        if mesh is not None:
            stages = list(zip(replicate_module(self.clip_text, mesh),
                              replicate_module(self.sag, mesh)))
            self._sharded_sketch = shard_sample_fn(_shard_sketch, mesh, stages,
                                                   batched=(True, True))

    @torch.no_grad()
    def semantic_sketch(self, sentences: Sequence[str],
                        seed_motion: torch.Tensor) -> torch.Tensor:
        """The SAG decode of the text features of ``sentences``, seeded by
        the first frames of ``seed_motion`` [B, J, F, T]."""
        if self.lm:
            with annotate("compose.lm"):
                ids, lengths = self.tokenizer(list(sentences))
                z = self.clip_text(torch.as_tensor(ids), lengths)
        else:
            with annotate("compose.clip"):
                tokens = torch.from_numpy(self.tokenizer(list(sentences)))
                if self.mesh is None:
                    z = self.clip_text(tokens.to(self.device))
        seed = seed_motion.to(self.device, torch.float32)
        if self.mesh is not None:
            return self._sharded_sketch(tokens, seed)
        with annotate("compose.sag"):
            return self.sag.decode(z, seed)

    @torch.no_grad()
    def __call__(
        self,
        sentences: Sequence[str],
        cond: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        *,
        guidance=1.5,
    ) -> torch.Tensor:
        """Clips [B, J, F, T]: the sketch of ``sentences`` from
        ``cond["origin_x"]``, refined over the last ``num_timesteps -
        skip_timesteps`` steps under ``cond`` (on the models' device)."""
        sketch = self.semantic_sketch(sentences, cond["origin_x"])
        return self.rag_sampler(cond, generator, guidance=guidance,
                                skip_timesteps=self.skip_timesteps, init_image=sketch)


def _shard_sketch(stages, tokens, seed):
    """One shard's sketch on its (CLIP text tower, SAG) replicas, under the
    stage spans of the unsharded call."""
    clip_text, sag = stages
    with annotate("compose.clip"):
        z = clip_text(tokens)
    with annotate("compose.sag"):
        return sag.decode(z, seed)


def long_form_window_grid(n_audio_samples: int, nframes: int, n_pre_seq: int,
                          fps: int = 15, sr: int = 16000):
    """The window grid every long-form path shares (the generators here and
    ``serving.GestureBatcher.long_form_stream``).

    Windows of ``nframes`` overlap by ``n_pre_seq`` seed frames (hop =
    nframes - n_pre_seq); enough are laid down that ``nframes + (n-1)*hop
    >= total_frames`` (the tail window's audio is zero-padded by the
    caller), and the last window's output is cropped by ``excess`` so that
    the frames yielded sum to ``total_frames = max(int(n_audio_samples *
    fps / sr), nframes)``.

    Returns ``(n_windows, excess, hop, total_frames, sample_offsets)``,
    ``sample_offsets[w]`` the waveform start of window ``w``."""
    hop = nframes - n_pre_seq
    total_frames = max(int(n_audio_samples * fps / sr), nframes)
    n_windows = max(1, -(-(total_frames - nframes) // hop) + 1)
    excess = nframes + (n_windows - 1) * hop - total_frames
    offsets = [int(round(w * hop / fps * sr)) for w in range(n_windows)]
    return n_windows, excess, hop, total_frames, offsets


def generate_long_form(
    sampler: RAGSampler,
    audio: np.ndarray,
    speaker: int,
    generator: Optional[torch.Generator] = None,
    *,
    guidance: float = 1.5,
    fps: int = 15,
    sr: int = 16000,
    emotion: int = 0,
    pipeline: Optional[LivelySpeakerPipeline] = None,
    sentences: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Audio of any length -> one continuous gesture stream [J, F,
    total_frames], ``total_frames = int(len(audio) * fps / sr)`` (one window
    at least): the windows of :func:`long_form_window_grid`, generated in
    order, each seeded with the previous window's last ``n_pre_seq`` frames
    (the RAG's seed-frame conditioning). With ``pipeline`` and
    ``sentences`` (cycled) each window is a LivelySpeaker composition. A
    sampler with a mesh runs each window as a batch of the mesh's size
    (rows copied from the window) and keeps row 0.
    Every window draws from ``generator`` in turn (the JAX package splits a
    key per window instead). :func:`generate_long_form_stream` yields the
    same frames window by window."""
    chunks = generate_long_form_stream(
        sampler, audio, speaker, generator, guidance=guidance, fps=fps, sr=sr,
        emotion=emotion, pipeline=pipeline, sentences=sentences)
    return np.concatenate([c for _, c in chunks], axis=-1)


def generate_long_form_stream(
    sampler: RAGSampler,
    audio: np.ndarray,
    speaker: int,
    generator: Optional[torch.Generator] = None,
    *,
    guidance: float = 1.5,
    fps: int = 15,
    sr: int = 16000,
    emotion: int = 0,
    pipeline: Optional[LivelySpeakerPipeline] = None,
    sentences: Optional[Sequence[str]] = None,
):
    """Generator form of :func:`generate_long_form`: yields ``(window,
    new_frames [J, F, K])`` as each window completes, K = nframes for window
    0 and nframes - n_pre_seq after (the last window cropped so the total
    matches the audio). The windows run on the sampler's device."""
    c = sampler.model.cfg
    nf, pre = c.nframes, c.n_pre_seq
    n_windows, excess, _, _, offsets = long_form_window_grid(len(audio), nf, pre, fps=fps, sr=sr)
    dev = sampler.device
    mesh = getattr(sampler, "mesh", None)
    rows = mesh.size if mesh is not None else 1
    seed = np.zeros((rows, c.njoints, c.nfeats, nf), np.float32)
    win_samples = int(round(nf / fps * sr))
    vid = torch.full((rows,), speaker, device=dev)
    for w in range(n_windows):
        wav = np.zeros((rows, win_samples), np.float32)
        chunk = np.asarray(audio[offsets[w]: offsets[w] + win_samples], np.float32)
        wav[:, : len(chunk)] = chunk
        cond = {"audio": torch.from_numpy(wav).to(dev), "vid": vid,
                "origin_x": torch.tensor(seed, device=dev)}
        if c.num_emotions:  # a BEAT model needs its emotion token
            cond["emo"] = torch.full((rows,), emotion, device=dev)
        if pipeline is not None and sentences:
            clip = pipeline([sentences[w % len(sentences)]] * rows, cond, generator,
                            guidance=guidance)
        else:
            clip = sampler(cond, generator, guidance=guidance)
        clip = clip[0].cpu().numpy()  # [J, F, nf]
        # windows after the first re-synthesise their seed frames: dropped
        out = clip if w == 0 else clip[:, :, pre:]
        if w == n_windows - 1 and excess:
            out = out[:, :, :-excess]
        yield w, out
        seed[:] = 0.0
        seed[:, :, :, :pre] = clip[:, :, -pre:]
