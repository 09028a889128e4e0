"""The port's training entry points against the JAX package: the argument
layer (``utils/config.py``), the SAG train step (one and two Adam steps with
dropout off: loss within rel 1e-5, gradients within 1e-4 of each tensor's
max, updated parameters within rel 1e-5, the attention's key bias, whose
gradient is 0 in exact arithmetic, within Adam's step size), and ``train_rag`` / ``train_sag``
run in-process on ``--device cpu`` at latent 32, whose checkpoints the JAX
package's RAG and SAG read and answer within rel 1e-5 of the port, and
which the port's ``scripts/serve.py`` serves. The JAX scripts' mesh options
raise, and so does the default device without a card.
"""

import glob
import json
import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from livelyspeaker_tpu.models import RAG as JRAG
from livelyspeaker_tpu.models import RAGConfig as JRAGConfig
from livelyspeaker_tpu.models import sag as jsag
from livelyspeaker_tpu.training import checkpoints as jckpt
from livelyspeaker_tpu.utils import config as jconfig
from livelyspeaker_tpu_torch import models
from livelyspeaker_tpu_torch.data.synthetic import (
    build_synthetic_beat_records,
    build_synthetic_ted_records,
)
from livelyspeaker_tpu_torch.models import SAG, CLIPTextConfig, CLIPTextEncoder
from livelyspeaker_tpu_torch.scripts import serve, train_rag, train_sag
from livelyspeaker_tpu_torch.utils import config as tconfig
from livelyspeaker_tpu_torch.utils.checkpoints import load_params_npz
from livelyspeaker_tpu_torch.utils.convert import jax_params_to_state_dict, random_normal_params

TOL = 1e-5
GRAD_TOL = 1e-4
SMALL = ["--latent_dim", "32", "--layers", "2", "--batch_size", "8", "--log_interval", "1"]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    ted = str(tmp_path_factory.mktemp("ted"))
    build_synthetic_ted_records(ted, n_clips=3, clip_seconds=10, seed=31)
    beat = str(tmp_path_factory.mktemp("beat"))
    build_synthetic_beat_records(beat, n_clips=2, clip_seconds=5, seed=32)
    return {"ted": ted, "beat": beat}


# --- arguments ---------------------------------------------------------------

ARGVS = [
    [],
    ["--dataset", "beat", "--lr", "3e-4", "--fused_train", "--device_resident", "1",
     "--layers", "4", "--epochs", "7"],
    ["--schedule_sampler", "loss-second-moment", "--ema_rate", "0.999", "--ema_warmup",
     "--noise_schedule", "linear", "--resume_checkpoint", "x"],
    ["-c", "CONFIG"],
    ["--config", "CONFIG", "--latent_dim", "64"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_train_args_match_jax(tmp_path, argv):
    cfg = tmp_path / "beat.json"
    cfg.write_text(json.dumps({"dataset": "beat", "njoints": 47, "nfeats": 6,
                               "num_emotions": 8, "latent_dim": 128, "unknown_key": 1}))
    argv = [str(cfg) if a == "CONFIG" else a for a in argv]
    ours, theirs = vars(tconfig.train_args(list(argv))), vars(jconfig.train_args(list(argv)))
    assert ours.pop("device") is None and theirs.pop("device") == 0
    assert ours == theirs
    assert vars(tconfig.train_args(argv + ["--device", "cpu"]))["device"] == "cpu"


def test_generate_args_restore_the_saved_groups_as_jax(tmp_path):
    with open(tmp_path / "args.json", "w") as f:
        json.dump({"latent_dim": 48, "layers": 3, "dataset": "beat", "lr": 5.0,
                   "guidance_param": 9.0}, f)
    argv = ["--model_path", str(tmp_path / "model000000010.npz"), "--guidance_param", "2.5"]
    ours, theirs = vars(tconfig.generate_args(argv)), vars(jconfig.generate_args(argv))
    ours.pop("device"), theirs.pop("device")
    assert ours == theirs and ours["latent_dim"] == 48 and ours["guidance_param"] == 2.5


# --- the SAG step ------------------------------------------------------------

def _sag_pair(seed=0):
    kw = dict(njoints=9, nfeats=3, latent_dim=32, ff_size=64, num_layers=2, num_heads=4)
    x = np.random.default_rng(seed).normal(size=(6, 9, 3, 34)).astype(np.float32)
    jm = jsag.SAG(**kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    params = random_normal_params(jax.device_get(params), np.random.default_rng(seed + 1))
    tm = SAG(**kw)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return jm, params, tm, x


@pytest.mark.parametrize("steps", [1, 2])
def test_sag_train_step_matches_jax_with_dropout_off(steps):
    jm, params, tm, x = _sag_pair()
    text = np.random.default_rng(3).normal(size=(6, 32)).astype(np.float32)
    lr, lam = 1e-3, 0.7
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), deterministic=True)
        losses = jsag.sag_losses(jnp.asarray(x), out["output"], out["z"], jnp.asarray(text),
                                 lam_cos=lam)
        return losses["sum"], losses

    @jax.jit
    def jax_step(params, opt_state):
        (_, jlosses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, jlosses, grads

    tm.eval()  # dropout off
    step = train_sag.make_sag_train_step(tm, torch.optim.Adam(tm.parameters(), lr=lr), lam)
    for _ in range(steps):
        params, opt_state, jlosses, grads = jax_step(params, opt_state)
        losses = step(torch.from_numpy(x), torch.from_numpy(text))
        for k, v in jlosses.items():
            assert rel(losses[k].numpy(), v) <= TOL, k
        jgrads = jax_params_to_state_dict(jax.device_get(grads))
        for name, p in tm.named_parameters():
            g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            ref = jgrads[name].numpy()
            scale = max(np.abs(ref).max(), 1e-12)
            assert np.abs(g - ref).max() <= GRAD_TOL * scale, name
    new = jax_params_to_state_dict(jax.device_get(params))
    for name, p in tm.named_parameters():
        ours, ref = p.detach().numpy(), new[name].numpy()
        if name.endswith("in_proj_bias"):
            # the key bias's gradient is 0 in exact arithmetic (softmax is
            # blind to a constant added to every logit of a row): Adam turns
            # either side's rounding noise into steps of up to lr, so those
            # rows are held to steps * lr, the rest as every parameter
            d = ours.shape[0] // 3
            assert np.abs(ours[d:2 * d] - ref[d:2 * d]).max() <= steps * lr * 1.001, name
            ours, ref = np.delete(ours, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        assert rel(ours, ref) <= TOL, name


def test_sag_train_step_with_dropout_is_finite_and_draws_from_the_seed():
    outs = []
    for _ in range(2):
        _, _, tm, x = _sag_pair(seed=4)
        tm.train()
        torch.manual_seed(9)
        step = train_sag.make_sag_train_step(tm, torch.optim.Adam(tm.parameters(), lr=1e-3), 1.0)
        losses = step(torch.from_numpy(x), torch.ones(6, 32))
        assert all(bool(torch.isfinite(v)) for v in losses.values())
        outs.append(losses["sum"].item())
    assert outs[0] == outs[1]
    tm.eval()
    det = train_sag.make_sag_train_step(tm, torch.optim.Adam(tm.parameters(), lr=0.0), 1.0)
    assert det(torch.from_numpy(x), torch.ones(6, 32))["sum"].item() != outs[0]


# --- train_rag ---------------------------------------------------------------

def _progress(save_dir, key="loss"):
    with open(os.path.join(save_dir, "progress.jsonl")) as f:
        return [json.loads(line)[key] for line in f if key in json.loads(line)]


def _rag_output_matches_jax(npz, args, beat):
    """The JAX RAG on the exported tree against the port's RAG loaded from
    the same npz, on one deterministic batch."""
    cfg_kw = dict(njoints=args["njoints"], nfeats=args["nfeats"], latent_dim=args["latent_dim"],
                  num_layers=args["layers"], n_speakers=max(args["n_speakers"], 30),
                  num_emotions=args["num_emotions"])
    tree = jckpt.load_params_npz(npz)
    tm = models.RAG(models.RAGConfig(**cfg_kw))
    tm.load_state_dict(jax_params_to_state_dict(load_params_npz(npz)))
    rng = np.random.default_rng(7)
    b, c = 3, tm.cfg
    x = rng.normal(size=(b, c.njoints, c.nfeats, 34)).astype(np.float32)
    cond = {"audio": (0.1 * rng.normal(size=(b, 36267))).astype(np.float32),
            "vid": np.array([0, 1, 2]), "origin_x": x,
            "style_eps": rng.normal(size=(b, 1, c.latent_dim)).astype(np.float32),
            "cond_drop": np.zeros((b,), np.float32)}
    if beat:
        cond["emo"] = np.array([1, 5, 7])
    t = np.array([0, 50, 999])
    ref = JRAG(JRAGConfig(**cfg_kw)).apply(
        {"params": tree}, jnp.asarray(x), jnp.asarray(t),
        {k: jnp.asarray(v) for k, v in cond.items()})["output"]
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {k: torch.from_numpy(v) for k, v in cond.items()})["output"]
    assert rel(out.numpy(), ref) <= TOL
    return tm


@pytest.mark.parametrize("dataset", ["ted", "beat"])
@pytest.mark.parametrize("resident", ["0", "1"])
def test_train_rag_trains_and_writes_what_the_jax_package_reads(records, tmp_path, dataset,
                                                                  resident):
    save = str(tmp_path / "run")
    loop = train_rag.main(["--dataset", dataset, "--data_dir", records[dataset], "--device",
                           "cpu", "--save_dir", save, "--epochs", "2", "--fused_train",
                           "--device_resident", resident, *SMALL])
    losses = _progress(save)
    assert len(losses) == loop.step > 0 and np.all(np.isfinite(losses))
    args = jckpt.load_args(save)
    assert args["device"] == "cpu" and args["fused_train"] is True
    if dataset == "beat":
        assert (args["njoints"], args["nfeats"], args["num_emotions"]) == (47, 6, 8)
        assert loop.model.cfg.n_speakers == max(args["n_speakers"], 30)
        assert loop.cfg.kld_weight == 0.0
    else:
        assert loop.cfg.kld_weight == 0.01
    npz = os.path.join(save, f"model{loop.step:09d}.npz")
    assert os.path.exists(npz) and glob.glob(os.path.join(save, "ckpt_*.pt"))
    tm = _rag_output_matches_jax(npz, args, dataset == "beat")
    for k, v in loop.model.state_dict().items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)


def test_train_rag_resume_replays_the_uninterrupted_run(records, tmp_path):
    base = ["--dataset", "ted", "--data_dir", records["ted"], "--device", "cpu",
            "--save_interval", "1", *SMALL]
    whole = train_rag.main(base + ["--save_dir", str(tmp_path / "a"), "--epochs", "2"])
    train_rag.main(base + ["--save_dir", str(tmp_path / "b"), "--epochs", "1"])
    resumed = train_rag.main(base + ["--save_dir", str(tmp_path / "b"), "--epochs", "2",
                                     "--resume_checkpoint", "1"])
    assert resumed.start_step == len(resumed.data) and resumed.step == whole.step
    for k, v in whole.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)


def test_train_rag_on_synthetic_records(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    loop = train_rag.main(["--dataset", "synthetic", "--device", "cpu", "--epochs", "1",
                           "--save_dir", str(tmp_path / "run"), *SMALL, "--batch_size", "64"])
    assert os.path.exists(os.path.join(str(tmp_path), train_rag.SYNTHETIC_DIR, "meta.json"))
    assert loop.step == len(loop.data) == 208 // 64


def test_train_rag_checkpoint_is_served(records, tmp_path):
    save = str(tmp_path / "run")
    loop = train_rag.main(["--dataset", "ted", "--data_dir", records["ted"], "--device", "cpu",
                           "--save_dir", save, "--epochs", "1", *SMALL])
    npz = os.path.join(save, f"model{loop.step:09d}.npz")
    srv, batcher = serve.build_server(["--model_path", npz, "--port", "0", "--device", "cpu",
                                       "--steps", "50", "--timestep_respacing", "ddim5"])
    try:
        for k, v in loop.model.state_dict().items():
            torch.testing.assert_close(batcher.sampler.model.state_dict()[k], v, rtol=0, atol=0)
        clip = batcher.generate(np.zeros(16000, np.float32), timeout=600.0)
        assert clip.shape == (9, 3, 34) and np.all(np.isfinite(clip))
    finally:
        srv.server_close()
        batcher.close()


# --- train_sag ---------------------------------------------------------------

def test_train_sag_logs_fgd_and_writes_what_the_jax_package_reads(records, tmp_path, capsys):
    save = str(tmp_path / "sag")
    out = train_sag.main(["--dataset", "ted", "--data_dir", records["ted"], "--device", "cpu",
                          "--save_dir", save, "--epochs", "2", "--latent_dim", "32",
                          "--clip_layers", "1", "--batch_size", "8", "--log_interval", "1",
                          "--eval_interval", "1"])
    assert "new best FGD" in capsys.readouterr().out
    sums, fgds = _progress(save, "sum"), _progress(save, "eval_fgd")
    assert len(sums) == out["step"] and np.all(np.isfinite(sums))
    assert len(fgds) == 2 and min(fgds) == out["best_fgd"] and np.isfinite(out["best_fgd"])
    for name in ("sag_best.npz", f"sag{out['step']:09d}.npz", "args.json"):
        assert os.path.exists(os.path.join(save, name)), name
    tree = jckpt.load_params_npz(os.path.join(save, f"sag{out['step']:09d}.npz"))
    x = np.random.default_rng(8).normal(size=(3, 9, 3, 34)).astype(np.float32)
    ref = jsag.SAG(latent_dim=32).apply({"params": tree}, jnp.asarray(x))
    model = out["model"].eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    for k in ("z", "output"):
        assert rel(ours[k].numpy(), ref[k]) <= TOL, k


def test_train_sag_checkpoint_is_served(records, tmp_path, monkeypatch):
    """A SAG at the front end's width (latent 512) trained one epoch, then
    served as the composition's sketch."""
    save = str(tmp_path / "sag")
    train_sag.main(["--dataset", "ted", "--data_dir", records["ted"], "--device", "cpu",
                    "--save_dir", save, "--epochs", "1", "--clip_layers", "1",
                    "--batch_size", "4", "--eval_interval", "1"])
    rag = models.RAG(models.RAGConfig(latent_dim=32, num_layers=1, n_speakers=4))
    from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz

    save_params_npz(str(tmp_path / "rag.npz"), rag.state_dict(), rag)
    save_args(str(tmp_path), {"latent_dim": 32, "layers": 1, "n_speakers": 4})
    small = dict(vocab_size=49408, context_length=77, width=64, layers=1, heads=4, embed_dim=512)
    monkeypatch.setattr(models, "CLIPTextEncoder", lambda generator=None: CLIPTextEncoder(
        CLIPTextConfig(**small), generator=generator))
    srv, batcher = serve.build_server([
        "--model_path", str(tmp_path / "rag.npz"), "--sag_path", os.path.join(save, "sag_best.npz"),
        "--port", "0", "--device", "cpu", "--steps", "50", "--timestep_respacing", "ddim5",
        "--composition_respacing", "ddim5", "--skip_steps", "3"])
    try:
        sd = load_params_npz(os.path.join(save, "sag_best.npz"))
        ref = jax_params_to_state_dict(sd)
        for k, v in batcher.composition.sag.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
        clip = batcher.generate(np.zeros(16000, np.float32), text="hello there", timeout=600.0)
        assert clip.shape == (9, 3, 34) and np.all(np.isfinite(clip))
    finally:
        srv.server_close()
        batcher.close()


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("script", [train_rag, train_sag])
@pytest.mark.parametrize("flags,match", [
    (["--pipeline_parallel", "2", "--fused_train"], "pipeline_parallel"),
    (["--fsdp", "--fused_train", "--device", "cpu,cpu"], "fsdp"),
    (["--device", "cuda:0,cuda:1"], "CUDA devices"),
])
def test_mesh_options_raise(records, tmp_path, script, flags, match):
    """train_rag raises what the JAX script refuses (``--pipeline_parallel``
    or ``--fsdp`` on several devices with ``--fused_train``) and a list
    that names absent cards (it trains over a list that is there);
    train_sag trains on one device, as the JAX script does, and refuses
    ``--fsdp`` and any list."""
    if script is train_sag and flags[0] == "--pipeline_parallel":
        match = None  # argparse refuses it first, as in the JAX script
    if script is train_sag and flags[0] == "--device":
        match = "on one device"
    with pytest.raises(SystemExit, match=match):
        script.main(["--dataset", "ted", "--data_dir", records["ted"], "--save_dir",
                     str(tmp_path), *flags])


@pytest.mark.parametrize("script", [train_rag, train_sag])
def test_default_device_needs_a_card(records, tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        script.main(["--dataset", "ted", "--data_dir", records["ted"], "--save_dir",
                     str(tmp_path), "--latent_dim", "32", "--clip_layers", "1"]
                    if script is train_sag else
                    ["--dataset", "ted", "--data_dir", records["ted"], "--save_dir",
                     str(tmp_path), *SMALL])
