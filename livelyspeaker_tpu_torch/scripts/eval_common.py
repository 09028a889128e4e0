"""What the eval entry points share: the SAG, CLIP and tokenizer loaders, the
two-stage pipeline, the BEAT FID embedder, the latest checkpoint of a run,
the data-parallel guard, and a clock of where an eval's time goes.

Port of the JAX package's ``scripts/eval_common.py`` (the reference repeats
this loading in each eval script: ``scripts/test_LivelySpeaker_ted.py:38-54``,
``scripts_beat/test_LivelySpeaker_beat.py:33-41``). The weights live in the
modules; every model goes to ``args.device``, which is the card unless it
says otherwise (``utils/device.py``'s rule).

What the measurement studies share (``soak_flagship``, ``measure_*``,
``experiments/distillation``): :func:`fixture_fgd`, DDIM through
``RAGSampler`` over a whole dataset scored against a frozen fixture
embedder; :func:`fixture_evaluator`, that embedder with seeded weights
(the JAX studies' ``PRNGKey(11)`` becomes ``torch.Generator`` seed 11);
:func:`xt_boundary_probe`, the one-shot x0 at the skip boundary; and
:func:`run_train_rag`, a ``train_rag`` run in a process of its own.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["load_sag_params", "load_clip", "load_tokenizer", "build_pipeline",
           "load_beat_embedder", "mesh_from_args", "final_npz", "PhaseClock",
           "fixture_evaluator", "fixture_fgd", "xt_boundary_probe", "train_rag_steps",
           "train_rag_command", "run_train_rag", "FIXTURE_SEED"]

FIXTURE_SEED = 11  # the frozen fixture embedder's weights
# the root of the checkout, where ``python -m livelyspeaker_tpu_torch...`` runs
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mesh_from_args(args, batch_size: Optional[int] = None):
    """The mesh of ``--data_parallel``: None at 1; above 1 the first N
    cards (``--device cpu``: the CPU N times), over which the sampler splits
    each batch. Raises where there are fewer cards, or where N does not
    divide ``batch_size``, the batch the sampler sees (``args.batch_size``
    by default), as the JAX function does."""
    from ..parallel.mesh import data_parallel_mesh

    dp = getattr(args, "data_parallel", 1)
    if dp <= 1:
        return None
    eff = batch_size if batch_size is not None else getattr(args, "batch_size", None)
    if eff and eff % dp:
        raise SystemExit(f"batch size {eff} must be a multiple of --data_parallel {dp}")
    try:
        return data_parallel_mesh(dp, args.device)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"--data_parallel {dp}: {e}") from e


def load_sag_params(path: str) -> Dict[str, torch.Tensor]:
    """The SAG's state_dict from the portable npz or the released torch
    ``.pth`` (test_LivelySpeaker_ted.py:40-47)."""
    from ..utils import convert

    if path.endswith(".npz"):
        from ..utils.checkpoints import load_params_npz

        return convert.jax_params_to_state_dict(load_params_npz(path))
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return convert.sag_state_dict_from_reference(sd)


def load_clip(args):
    """The frozen CLIP ViT-B/32 text tower (motionclip.py:96-104): OpenAI's
    weights from ``--clip_path``, else a seeded random tower that keeps the
    pipeline runnable without them."""
    from ..models import CLIPTextEncoder
    from ..utils.convert import clip_text_state_dict_from_openai

    if getattr(args, "clip_path", ""):
        clip = CLIPTextEncoder()
        sd = torch.load(args.clip_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        clip.load_state_dict(clip_text_state_dict_from_openai(sd, layers=clip.cfg.layers))
        return clip
    print("WARNING: random frozen CLIP text tower (no --clip_path)")
    return CLIPTextEncoder(generator=torch.Generator().manual_seed(1))


def load_tokenizer(args):
    from ..data import CLIPTokenizer, HashTokenizer

    return (CLIPTokenizer(args.bpe_path) if getattr(args, "bpe_path", "")
            else HashTokenizer())


def build_pipeline(args, rag, njoints: int, nfeats: int, mesh=None):
    """The two-stage composition: the SAG's sketch, q-sampled to T - skip,
    refined by ``rag`` under CFG (test_LivelySpeaker_ted.py:85-113,
    test_LivelySpeaker_beat.py:101-130), on ``args.device``, or split over
    ``mesh``."""
    from ..models import SAG
    from ..pipeline import LivelySpeakerPipeline

    sag = SAG(njoints=njoints, nfeats=nfeats, latent_dim=512,  # = CLIP's text width
              generator=torch.Generator().manual_seed(0))
    if getattr(args, "sag_path", ""):
        sag.load_state_dict(load_sag_params(args.sag_path))
    else:
        print("WARNING: random-init SAG (no --sag_path)")
    clip = load_clip(args)
    tokenizer = load_tokenizer(args)
    if (getattr(args, "guidance_param", 1.0) > 1.0
            and not getattr(args, "guidance_schedule", None)):
        # measured in the JAX package (BASELINE.md, DESIGN §18-19): at
        # guidance > 1 constant CFG erodes the sketch's text-borne signal in
        # the low-t refinement steps; the reference's own sweep hits this
        print(
            f"WARNING: composition at guidance={args.guidance_param} with "
            "constant CFG erodes the SAG sketch's semantic contribution; "
            "pass --guidance_schedule cosine to preserve it "
            "(measured: BASELINE.md 'guidance schedules')",
            file=sys.stderr,
        )
    return LivelySpeakerPipeline(
        rag, sag, clip, tokenizer,
        steps=args.diffusion_steps,
        timestep_respacing=args.timestep_respacing or "ddim100",
        skip_timesteps=args.skip_steps or 80,  # test_LivelySpeaker_beat.py:232
        guidance_schedule=getattr(args, "guidance_schedule", None),
        use_fused=getattr(args, "fused", False),
        device=None if mesh is not None else args.device,
        mesh=mesh,
    )


def load_beat_embedder(args) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """The frozen HalfEmbeddingNet FID embedder (other_tools.py:76-79) from
    ``--eval_model_path`` on ``args.device``, or None without one: a
    function of host poses [B, T, 282] to host features."""
    from ..models.embedding_net import BeatEmbeddingEncoder
    from ..utils.convert import pose_embedding_state_dict_from_torch
    from ..utils.device import place_model

    if not (args.eval_model_path and os.path.exists(args.eval_model_path)):
        return None
    ckpt = torch.load(args.eval_model_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state") or ckpt.get("state_dict") or ckpt
    enc = BeatEmbeddingEncoder()
    enc.load_state_dict(pose_embedding_state_dict_from_torch(sd))
    device = place_model(enc.eval(), args.device, "the BEAT FID embedder")

    @torch.no_grad()
    def embed(poses: np.ndarray) -> np.ndarray:
        return enc(torch.as_tensor(poses).to(device, torch.float32)).cpu().numpy()

    return embed


def final_npz(save_dir: str, prefix: str = "model") -> str:
    """The latest ``{prefix}*.npz`` of a training save_dir (``"model"``
    leaves out the ``model_ema*`` exports, ``"model_ema"`` picks them)."""
    paths = sorted(
        p for p in glob.glob(os.path.join(save_dir, f"{prefix}*.npz"))
        if "ema" not in os.path.basename(p) or prefix.endswith("ema")
    )
    if not paths:
        raise FileNotFoundError(f"no {prefix}*.npz in {save_dir}")
    return paths[-1]


class PhaseClock:
    """Host seconds an eval spends by phase (sampling, and each metric's
    scoring). A phase ends with a device synchronise, so the card's queued
    work is charged to the phase that queued it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self._start = time.perf_counter()

    @contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds[phase] = self.seconds.get(phase, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        """``seconds: wall=... sampling=... <metric>=...``: the wall since
        construction and each phase's sum, on the host clock."""
        wall = time.perf_counter() - self._start
        return "seconds: " + " ".join(
            f"{k}={v:.3f}" for k, v in [("wall", wall)] + list(self.seconds.items()))


def fixture_evaluator(pose_dim: int = 27, *, beat: bool = False, n_frames: int = 34,
                      device=None):
    """The frozen fixture embedder of the studies, seeded
    (:data:`FIXTURE_SEED`): ``TedEmbeddingEncoder`` at ``pose_dim`` (27 on
    TED, 282 for the BEAT soak), or with ``beat`` the 282-d
    ``BeatEmbeddingEncoder`` of the BEAT semantic study. FGD deltas between
    runs need a fixed embedding map, not trained weights; the reference's
    trained evaluator waits for its release files."""
    from ..eval import EmbeddingSpaceEvaluator
    from ..models.embedding_net import BeatEmbeddingEncoder, TedEmbeddingEncoder

    g = torch.Generator().manual_seed(FIXTURE_SEED)
    net = (BeatEmbeddingEncoder(n_frames=n_frames, generator=g) if beat
           else TedEmbeddingEncoder(pose_dim=pose_dim, n_frames=n_frames, generator=g))
    return EmbeddingSpaceEvaluator.from_module(net, device)


def _flat(m: np.ndarray, nframes: int) -> np.ndarray:
    """[B, J, F, T] -> [B, T, J*F]."""
    return m.transpose(0, 3, 1, 2).reshape(m.shape[0], nframes, -1)


def fixture_fgd(model, dataset, model_path: str, fixture, *, batch_size: int = 64,
                timestep_respacing: str = "ddim20", guidance: float = 1.0, seed: int = 233,
                device=None) -> float:
    """FGD of a checkpoint against a frozen fixture embedder: ``model_path``
    (the portable npz) loaded into ``model``, the whole ``dataset`` sampled
    in order (batches of ``batch_size``, the tail dropped) by DDIM through
    ``RAGSampler`` (unfused, as the JAX sampler defaults), on ``device``
    (the card by default). One ``torch.Generator`` seeded ``seed`` drives
    the chains where the JAX loop splits a key a batch."""
    from ..data import DataLoader
    from ..pipeline import RAGSampler
    from ..utils import convert
    from ..utils.checkpoints import load_params_npz

    model.load_state_dict(convert.jax_params_to_state_dict(load_params_npz(model_path)))
    sampler = RAGSampler(model, steps=1000, timestep_respacing=timestep_respacing,
                         method="ddim", device=device)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=True, seed=seed)
    fixture.reset()
    generator = torch.Generator(device=sampler.device).manual_seed(seed)
    nf = model.cfg.nframes
    for batch in loader:
        cond = {"audio": batch["audio"], "vid": batch["vid"], "origin_x": batch["motion"]}
        if "emo" in batch:  # BEAT conditioning (scripts_beat RAG.py:125-126)
            cond["emo"] = batch["emo"]
        cond = {k: torch.from_numpy(np.asarray(v)).to(sampler.device) for k, v in cond.items()}
        sample = sampler(cond, generator, guidance=guidance).cpu().numpy()
        # TED windows carry the flat vec_seq; BEAT's rot6d motion flattens
        # as the FID protocol does (test_RAG_beat.py)
        real = batch["vec_seq"] if "vec_seq" in batch else _flat(batch["motion"], nf)
        fixture.push_samples(_flat(sample, nf), real)
    fgd, _ = fixture.get_scores()
    return float(fgd)


@torch.no_grad()
def xt_boundary_probe(spaced, base_sched, model, motion, cond, skip: int, *,
                      noise: Optional[torch.Tensor] = None,
                      style_eps: Optional[torch.Tensor] = None,
                      noise_seed: int = 5, style_seed: int = 6):
    """The x_t probe of the two semantic-payoff studies: real ``motion``
    q-sampled (under ``base_sched``, unspaced) to the noise level of the
    skip boundary, and the denoiser's one-shot x0 there. Returns
    ``(t_boundary, x0_hat)``, x0_hat on the host.

    A classifier that scores x0_hat about 1.0 says the denoiser keeps the
    mode content x_t carries (a low composed recall is then the refinement
    eroding it); about chance says the model memorised x0 = f(cond), and no
    sketch can survive. ``spaced`` is the respaced schedule the sampler
    runs: its ``timestep_map`` turns the boundary index ``num_timesteps -
    skip - 1`` (``skip`` in respaced steps; out of range raises) into an
    original-process timestep. ``noise`` and ``style_eps`` [B, 1, D]
    replace the draws of ``torch.Generator``s seeded ``noise_seed`` and
    ``style_seed`` (the JAX function's keys 5 and 6)."""
    n = int(spaced.num_timesteps)
    idx = n - int(skip) - 1
    if not 0 <= idx < n:
        raise ValueError(f"skip {skip} out of range for {n} respaced steps")
    t_boundary = int(spaced.timestep_map[idx])
    device = next(model.parameters()).device
    motion = torch.as_tensor(np.asarray(motion, np.float32)).to(device)
    b = motion.shape[0]
    if noise is None:
        noise = torch.randn(motion.shape, device=device,
                            generator=torch.Generator(device).manual_seed(noise_seed))
    if style_eps is None:
        style_eps = torch.randn((b, 1, model.cfg.latent_dim), device=device,
                                generator=torch.Generator(device).manual_seed(style_seed))
    from ..diffusion.sampling import q_sample

    t = torch.full((b,), t_boundary, dtype=torch.long, device=device)
    xb = q_sample(base_sched.to(device), motion, t, noise.to(device))
    cond = {**cond, "style_eps": style_eps.to(device)}
    x0_hat = model(xb, t, cond, train=False)["output"]
    return t_boundary, x0_hat.cpu().numpy()


def train_rag_steps(model, train_ds, fields: Sequence[str], steps: int, batch_size: int,
                    lr: float, device, kld_weight: float = 0.01) -> None:
    """``steps`` AdamW steps of ``model`` (in place) on batches gathered on
    the device, the draws of step i from ``training.loop.step_generator(0,
    i)`` (the JAX loop folds step i into key 0)."""
    from ..data import DeviceDataLoader
    from ..diffusion import DiffusionSchedule
    from ..training import TrainConfig
    from ..training.loop import step_generator
    from ..training.trainer import init_train_state, make_optimizer, make_train_step

    loader = DeviceDataLoader(train_ds, batch_size=min(batch_size, len(train_ds)),
                              shuffle=True, seed=233, fields=fields, device=device)
    sched = DiffusionSchedule.create(steps=1000, schedule="cosine").to(device)
    tcfg = TrainConfig(lr=lr, kld_weight=kld_weight)
    tx = make_optimizer(tcfg)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=tcfg, num_timesteps=1000)
    step = make_train_step(model, sched, tx, tcfg)
    model.train()
    done, t0, m = 0, time.time(), None
    while done < steps:
        for batch in loader:
            if done >= steps:
                break
            state, m = step(state, batch, step_generator(0, done, device))
            done += 1
    model.eval()
    print(f"RAG trained: {done} steps loss={m['loss']:.4f} ({time.time() - t0:.0f}s)",
          file=sys.stderr)


def train_rag_command(argv, *, cudnn_deterministic: bool = False):
    """The command of one run of the port's ``train_rag`` on ``argv`` in a
    process of its own: ``python -m livelyspeaker_tpu_torch.scripts.train_rag
    argv``, or with ``cudnn_deterministic`` the same module run after
    ``torch.backends.cudnn.deterministic = True`` and ``benchmark = False``
    (the soak's pin; ``train_rag`` has no flag for it)."""
    if not cudnn_deterministic:
        return [sys.executable, "-m", "livelyspeaker_tpu_torch.scripts.train_rag", *argv]
    code = ("import runpy, torch; torch.backends.cudnn.deterministic = True; "
            "torch.backends.cudnn.benchmark = False; "
            "runpy.run_module('livelyspeaker_tpu_torch.scripts.train_rag', "
            "run_name='__main__', alter_sys=True)")
    return [sys.executable, "-c", code, *argv]


def run_train_rag(argv, *, device=None, cudnn_deterministic: bool = False,
                  capture: bool = False) -> subprocess.CompletedProcess:
    """Run :func:`train_rag_command` from the checkout's root, with
    ``--device`` passed through where one is given; raises with the run's
    last output when it fails. ``capture`` keeps its stdout and stderr."""
    argv = list(argv) + (["--device", str(device)] if device is not None else [])
    cmd = train_rag_command(argv, cudnn_deterministic=cudnn_deterministic)
    print("+", " ".join(cmd), file=sys.stderr, flush=True)
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=capture, text=True)
    if capture:
        sys.stderr.write(proc.stderr[-2000:])
    print(f"  -> rc={proc.returncode} in {time.time() - t0:.0f}s", file=sys.stderr, flush=True)
    if proc.returncode:
        tail = (proc.stdout or "")[-2000:] + (proc.stderr or "")[-2000:]
        raise RuntimeError(f"train_rag failed ({proc.returncode}): {' '.join(argv)}\n{tail}")
    return proc
