"""The plain reference against the port, at tiny sizes on the CPU: the
RAG forward, both CFG samplers, three training steps with AdamW, CLIP's
text tower and the SAG decode. Same weights, same inputs, same draws."""

import copy

import pytest
import torch

from benchmark import harness
from benchmark.kinds.common import build_rag
from benchmark.reference import diffusion, rag, text
from benchmark.weights import seeded_tensors, shapes_of

from .conftest import TINY_CONFIG

CPU = torch.device("cpu")


def _config(name):
    spec = harness.load_spec()
    cfg = copy.deepcopy(harness.load_json(harness.config_file(spec, name)))
    for group, kv in TINY_CONFIG.items():
        cfg[group].update(kv)
    return cfg


def _cond(cfg, b, g):
    c = cfg["rag"]
    cond = {"audio": 0.1 * torch.randn(b, 36267, generator=g),
            "vid": torch.randint(c["n_speakers"], (b,), generator=g),
            "origin_x": torch.randn(b, c["njoints"], c["nfeats"], c["nframes"], generator=g)}
    if c["num_emotions"]:
        cond["emo"] = torch.randint(c["num_emotions"], (b,), generator=g)
    return cond


@pytest.mark.parametrize("config", ["livelyspeaker-ted", "livelyspeaker-beat"])
def test_forward_matches_port(config):
    cfg = _config(config)
    c = cfg["rag"]
    model, w = build_rag(cfg, 3, CPU)
    model.eval()
    g = torch.Generator().manual_seed(0)
    b = 3
    cond = _cond(cfg, b, g)
    x = torch.randn(b, c["njoints"], c["nfeats"], c["nframes"], generator=g)
    t = torch.randint(1000, (b,), generator=g)
    eps = torch.randn(b, 1, c["latent_dim"], generator=g)
    drop = torch.tensor([0.0, 1.0, 0.0])
    with torch.no_grad():
        want = model(x, t, {**cond, "style_eps": eps, "cond_drop": drop})["output"]
        feats = rag.wav_encoder(w, cond["audio"])
        got = rag.forward(w, c, x, t, feats, cond["vid"], cond["origin_x"], drop, eps,
                          cond.get("emo"))[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# of max|clip|: DPM-Solver++(2M)'s second-order correction amplifies f32
# rounding over its 20 steps (about 1e-4 here and on the card), DDIM's
# first-order steps do not (about 4e-6)
SAMPLER_TOL = {"dpmpp": 3e-4, "ddim": 2e-5}


@pytest.mark.parametrize("method,respacing", [("dpmpp", "ddim20"), ("ddim", "ddim10")])
@pytest.mark.parametrize("config", ["livelyspeaker-ted", "livelyspeaker-beat"])
def test_sampler_matches_port(config, method, respacing):
    from livelyspeaker_tpu_torch.pipeline import RAGSampler

    cfg = _config(config)
    model, w = build_rag(cfg, 5, CPU)
    sampler = RAGSampler(model, timestep_respacing=respacing, method=method, use_fused=True,
                         device=CPU)
    cond = _cond(cfg, 2, torch.Generator().manual_seed(1))
    scale = torch.tensor([1.0, 2.0])
    want = sampler(cond, torch.Generator().manual_seed(7), guidance=scale)
    got = diffusion.sample(w, cfg["rag"], cond, scale, torch.Generator().manual_seed(7),
                           method=method, respacing=respacing)
    assert max(harness.rel_gap(want[i], got[i]) for i in range(2)) < SAMPLER_TOL[method]


def test_skip_draws_matches_sample():
    cfg = _config("livelyspeaker-ted")
    c = cfg["rag"]
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    diffusion.skip_draws(a, c, 2, method="ddim", respacing="ddim10", skip=7)
    _, w = build_rag(cfg, 5, CPU)
    cond = _cond(cfg, 2, torch.Generator().manual_seed(1))
    diffusion.sample(w, c, cond, torch.ones(2), b, method="ddim", respacing="ddim10", skip=7,
                     init_image=torch.zeros(2, c["njoints"], c["nfeats"], c["nframes"]))
    assert torch.equal(torch.randn(4, generator=a), torch.randn(4, generator=b))


def test_schedule_matches_port():
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule

    for resp in (None, "ddim20", "ddim100"):
        port = DiffusionSchedule.create(steps=1000, schedule="cosine", timestep_respacing=resp)
        ref = diffusion.Schedule(1000, resp)
        assert ref.timesteps.tolist() == port.timestep_map.tolist()
        torch.testing.assert_close(torch.tensor(ref.acp, dtype=torch.float32),
                                   port.alphas_cumprod, rtol=1e-6, atol=1e-7)


def test_train_steps_match_port():
    from livelyspeaker_tpu_torch.diffusion import DiffusionSchedule
    from livelyspeaker_tpu_torch.training import (TrainConfig, init_train_state,
                                                  make_optimizer, make_train_step)

    cfg = _config("livelyspeaker-ted")
    c, tc = cfg["rag"], cfg["train"]
    model, w = build_rag(cfg, 9, CPU, fused_train_backbone=True)
    model.train()
    tcfg = TrainConfig(lr=tc["lr"], kld_weight=tc["kld_weight"])
    tx = make_optimizer(tcfg)
    state = init_train_state(dict(model.named_parameters()), tx, cfg=tcfg)
    step = make_train_step(model, DiffusionSchedule.create(steps=1000), tx, tcfg)
    g = torch.Generator().manual_seed(2)
    steps, losses = [], []
    for _ in range(3):
        batch = {"motion": torch.randn(4, c["njoints"], c["nfeats"], c["nframes"], generator=g),
                 "audio": 0.1 * torch.randn(4, 36267, generator=g),
                 "vid": torch.randint(c["n_speakers"], (4,), generator=g)}
        x = {"t": torch.randint(1000, (4,), generator=g),
             "noise": torch.randn(4, c["njoints"], c["nfeats"], c["nframes"], generator=g),
             "cond_drop": torch.tensor([0.0, 1.0, 0.0, 0.0]),
             "style_eps": torch.randn(4, 1, c["latent_dim"], generator=g)}
        state, m = step(state, batch, None, **x)
        losses.append(m["loss"])
        steps.append({"batch": batch, "t": x["t"], "noise": x["noise"], "drop": x["cond_drop"],
                      "style_eps": x["style_eps"]})
    ref = diffusion.train_steps(w, c, tc, steps)
    assert ref["losses"] == pytest.approx(losses, rel=1e-5)
    # by the benchmark's measure: leaves whose exact gradient is nought (the
    # conv biases before an InstanceNorm) take round-off steps under Adam
    change = {k: state.params[k].detach() - w[k] for k in w}
    ref_change = {k: ref["params"][k] - w[k] for k in w}
    assert harness.leaf_norm_gaps(change, ref_change, ref["first_grad"])[0] < 1e-3


def test_text_stage_matches_port():
    from livelyspeaker_tpu_torch.models import SAG, CLIPTextConfig, CLIPTextEncoder

    cfg = _config("livelyspeaker-beat")
    sag = SAG(**{k: cfg["sag"][k] for k in ("njoints", "nfeats", "latent_dim", "ff_size",
                                            "num_layers", "num_heads", "n_pre_poses")}).eval()
    clip = CLIPTextEncoder(CLIPTextConfig(**cfg["clip"])).eval()
    sw = seeded_tensors(shapes_of(sag), 1, "sag", CPU)
    cw = seeded_tensors(shapes_of(clip), 1, "clip", CPU)
    sag.load_state_dict(sw)
    clip.load_state_dict(cw)
    ids = torch.zeros(3, 77, dtype=torch.long)
    for i, n in enumerate((8, 12, 20)):
        ids[i, 0], ids[i, n - 1] = 49406, 49407
        ids[i, 1:n - 1] = torch.randint(1, 49406, (n - 2,),
                                        generator=torch.Generator().manual_seed(i))
    motion = torch.randn(3, 47, 6, 34, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        torch.testing.assert_close(text.clip_text(cw, cfg["clip"], ids), clip(ids),
                                   rtol=1e-5, atol=1e-5)
        z = clip(ids)
        torch.testing.assert_close(text.sag_decode(sw, cfg["sag"], z, motion),
                                   sag.decode(z, motion), rtol=1e-5, atol=1e-5)
