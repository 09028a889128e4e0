"""Diffusion schedules, CFG samplers and the training step in plain
PyTorch, float32: the benchmark's reference.

The schedule is the cosine one of Nichol and Dhariwal, respaced by DDIM
striding and computed in float64; the samplers are DDIM (eta 0) and
DPM-Solver++(2M) in its data-prediction form (Lu et al. 2022), under
classifier-free guidance with both passes in one batch of 2B rows (the
conditional half first). The training step is the x0-prediction diffusion
loss of LivelySpeaker's RAG (smooth L1 with beta 0.1 on poses and on their
velocities, plus the style token's KLD) and ``torch.optim.AdamW``.

Random draws follow the port's documented order (``diffusion/sampling.py``:
one generator a chain; the initial noise, then at each step the style
token of every row of the 2B-row batch, then the step's own noise for
DDIM), so the reference given the generator's seed sees the same draws.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import rag

__all__ = ["Schedule", "sample", "train_loss", "adamw"]


class Schedule:
    """Per-step tables of the cosine schedule of ``steps`` steps, respaced
    to ``respacing`` ("ddimN") or whole, as float64 numpy arrays."""

    def __init__(self, steps: int = 1000, respacing: Optional[str] = None):
        ab = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = np.array([min(1 - ab((i + 1) / steps) / ab(i / steps), 0.999)
                          for i in range(steps)])
        acp = np.cumprod(1.0 - betas)
        if respacing:
            n = int(respacing[len("ddim"):])
            stride = next(s for s in range(1, steps) if len(range(0, steps, s)) == n)
            kept = list(range(0, steps, stride))
        else:
            kept = list(range(steps))
        self.timesteps = np.array(kept)  # spaced index -> original timestep
        self.acp = acp[kept]
        self.acp_prev = np.append(1.0, self.acp[:-1])
        self.n = len(kept)


def _draw(shape, g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device)


def cfg_denoiser(p, cfg: Dict, cond: Dict[str, torch.Tensor], scale: torch.Tensor,
                 g: torch.Generator, pe: torch.Tensor) -> Callable:
    """(x, spaced index i, original timestep) -> the guided x0 estimate,
    out_u + scale * (out_c - out_u); each call draws the 2B rows' style
    tokens from ``g``."""
    b = cond["vid"].shape[0]
    feats = rag.wav_encoder(p, cond["audio"])
    dev = feats.device
    feats2 = torch.cat([feats, feats])
    drop = torch.cat([torch.zeros(b, device=dev), torch.ones(b, device=dev)])
    two = lambda v: None if v is None else torch.cat([v, v])
    vid2, origin2, emo2 = two(cond["vid"]), two(cond["origin_x"]), two(cond.get("emo"))
    s = scale.reshape(b, 1, 1, 1)

    def denoise(x, t_orig):
        eps = _draw((2 * b, 1, cfg["latent_dim"]), g)
        t = torch.full((2 * b,), int(t_orig), dtype=torch.long, device=dev)
        out = rag.forward(p, cfg, torch.cat([x, x]), t, feats2, vid2, origin2, drop, eps,
                          emo2, pe)[0]
        return out[b:] + s * (out[:b] - out[b:])

    return denoise


@torch.no_grad()
def sample(p, cfg: Dict, cond: Dict[str, torch.Tensor], scale: torch.Tensor,
           g: torch.Generator, *, method: str, respacing: str, steps: int = 1000,
           noise: Optional[torch.Tensor] = None, skip: int = 0,
           init_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clips [B, J, F, T] for ``cond`` ('audio', 'vid', 'origin_x' and on
    BEAT 'emo') at per-row guidance ``scale`` [B]: DDIM ("ddim", eta 0) or
    DPM-Solver++(2M) ("dpmpp") over the respaced chain, the first ``skip``
    steps skipped from ``init_image`` noised to the first step run.
    ``noise`` replaces the initial draw."""
    sch = Schedule(steps, respacing)
    b = cond["vid"].shape[0]
    shape = (b, cfg["njoints"], cfg["nfeats"], cfg["nframes"])
    pe = rag.sinusoid_table(rag.PE_ROWS, cfg["latent_dim"], cond["vid"].device)
    x = _draw(shape, g) if noise is None else noise.float()
    n = sch.n - skip
    if init_image is not None:
        a = sch.acp[n - 1]
        x = math.sqrt(a) * init_image.float() + math.sqrt(1.0 - a) * x
    denoise = cfg_denoiser(p, cfg, cond, scale, g, pe)
    if method == "ddim":
        for i in range(n - 1, -1, -1):
            x0 = denoise(x, sch.timesteps[i])
            _draw(shape, g)  # the step's noise, multiplied by eta = 0
            a, ap = sch.acp[i], sch.acp_prev[i]
            eps = (x * math.sqrt(1.0 / a) - x0) / math.sqrt(1.0 / a - 1.0)
            x = x0 * math.sqrt(ap) + math.sqrt(1.0 - ap) * eps
        return x
    if method != "dpmpp":
        raise ValueError(method)
    lam = lambda a: 0.5 * (math.log(a) - math.log(max(1.0 - a, 1e-20)))
    d_prev = h_prev = None
    for i in range(n - 1, 0, -1):
        d = denoise(x, sch.timesteps[i])
        a, ap = sch.acp[i], sch.acp_prev[i]
        h = lam(ap) - lam(a)
        if d_prev is None:
            dt = d
        else:
            c = 1.0 / (2.0 * h_prev / h)
            dt = (1.0 + c) * d - c * d_prev
        x = math.sqrt(1.0 - ap) / math.sqrt(1.0 - a) * x - math.sqrt(ap) * math.expm1(-h) * dt
        d_prev, h_prev = d, h
    return denoise(x, sch.timesteps[0])


def skip_draws(g: torch.Generator, cfg: Dict, b: int, *, method: str, respacing: str,
               steps: int = 1000, skip: int = 0) -> None:
    """Advance ``g`` past the draws of one :func:`sample` call of ``b``
    rows with no ``noise`` given, computing nothing else."""
    shape = (b, cfg["njoints"], cfg["nfeats"], cfg["nframes"])
    _draw(shape, g)
    for _ in range(Schedule(steps, respacing).n - skip):
        _draw((2 * b, 1, cfg["latent_dim"]), g)
        if method == "ddim":
            _draw(shape, g)


def _smooth_l1_ps(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Per-sample mean of smooth-L1(pred / beta, target / beta) * beta."""
    loss = F.smooth_l1_loss(pred / beta, target / beta, reduction="none", beta=1.0)
    return loss.flatten(1).mean(1) * beta


def train_loss(p, cfg: Dict, tcfg: Dict, batch: Dict[str, torch.Tensor], t: torch.Tensor,
               noise: torch.Tensor, drop: torch.Tensor, style_eps: torch.Tensor,
               pe: torch.Tensor) -> torch.Tensor:
    """The RAG's training loss of one batch at timesteps ``t`` [B] of the
    whole 1,000-step chain: q-sample, one forward (the WavEncoder inside),
    smooth L1 on poses and velocities, the KLD of the style token."""
    sch = Schedule(1000)
    acp = torch.tensor(sch.acp, dtype=torch.float32, device=t.device)[t].reshape(-1, 1, 1, 1)
    x0 = batch["motion"].float()
    xt = acp.sqrt() * x0 + (1.0 - acp).sqrt() * noise
    feats = rag.wav_encoder(p, batch["audio"])
    out, mu, logvar = rag.forward(p, cfg, xt, t, feats, batch["vid"].long(), x0, drop,
                                  style_eps, batch.get("emo"), pe)
    beta = tcfg["huber_beta"]
    vel = lambda a: a[..., 1:] - a[..., :-1]
    per = _smooth_l1_ps(out, x0, beta) + tcfg["lambda_vel"] * _smooth_l1_ps(vel(out), vel(x0),
                                                                             beta)
    kld = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return per.mean() + tcfg["kld_weight"] * kld


def adamw(params: Sequence[torch.Tensor], tcfg: Dict) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=tcfg["lr"], betas=tuple(tcfg["betas"]),
                             eps=tcfg["eps"], weight_decay=tcfg["weight_decay"])


def train_steps(p: Dict[str, torch.Tensor], cfg: Dict, tcfg: Dict,
                steps: List[Dict], adam: Optional[Dict] = None) -> Dict:
    """Run the training steps of ``steps`` (each: 'batch', 't', 'noise',
    'drop', 'style_eps') from the weights ``p`` (left unchanged) and, with
    ``adam``, from AdamW's state: 'count' updates applied and the moments
    'mu' and 'nu' by name (fresh otherwise). Returns each step's loss, the
    first step's gradient by name and the weights after the last step."""
    w = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    opt = adamw(list(w.values()), tcfg)
    if adam is not None:
        for n, v in w.items():
            opt.state[v] = {"step": torch.tensor(float(adam["count"])),
                            "exp_avg": adam["mu"][n].detach().clone(),
                            "exp_avg_sq": adam["nu"][n].detach().clone()}
    pe = rag.sinusoid_table(rag.PE_ROWS, cfg["latent_dim"], next(iter(p.values())).device)
    losses, first_grad = [], None
    for k, st in enumerate(steps):
        opt.zero_grad(set_to_none=True)
        loss = train_loss(w, cfg, tcfg, st["batch"], st["t"], st["noise"], st["drop"],
                          st["style_eps"], pe)
        loss.backward()
        if k == 0:
            first_grad = {n: (v.grad.detach().clone() if v.grad is not None
                              else torch.zeros_like(v)) for n, v in w.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad,
            "params": {n: v.detach() for n, v in w.items()}}
