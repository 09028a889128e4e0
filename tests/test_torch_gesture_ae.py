"""Parity of the port's gesture autoencoder with the JAX package: the
BatchNorm, the three decoders, ``GestureAutoencoder`` in train and eval
mode (with the batch statistics after a step), two Adam steps against
``optax.adam``, the weight bridge both ways, the training script end to end
on the CPU, and the TensorBoard and ClearML platforms.

The same seeded numpy inputs and the same randomised weights (carried with
``utils.convert.flax_variables_to_state_dict``) go through the Flax module
and the port. Outputs, gradients' effects and batch statistics are held
within rtol 1e-5 / atol 1e-5 (f32 sums over B*T rows in another order
through two or three BatchNorms; measured at most 4e-6 absolute on
outputs of magnitude 4). After two Adam steps the parameters are held
within atol 2e-6 of optax's (measured at most 1.3e-6, on one element of
fc0's kernel whose two steps' gradients nearly cancel, so Adam turns their
f32 rounding into 1e-3 of a step of lr 1e-3), apart from the biases whose effect a later
train-mode BatchNorm removes (a constant over the batch that reaches the
BatchNorm through linear layers only): their gradient is 0 in exact
arithmetic, so each
side's rounding noise is what Adam normalises, and those are held to
moving at most steps x lr from where they started, on both sides. The
running mean of the BatchNorm after such a bias takes (1 - momentum) of
the bias's difference at each later step, so the running means are held
within atol 1e-5 + 0.01 x 2 x (steps - 1) x lr; the variances within
1e-5. Each Flax function is compiled once (``jax.jit``).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from livelyspeaker_tpu.models import embedding_net as J
from livelyspeaker_tpu_torch.data.synthetic import build_synthetic_ted_records
from livelyspeaker_tpu_torch.models import embedding_net as T
from livelyspeaker_tpu_torch.scripts import train_gesture_autoencoder
from livelyspeaker_tpu_torch.training.logging import ClearmlPlatform, TensorboardPlatform
from livelyspeaker_tpu_torch.utils.checkpoints import load_params_npz
from livelyspeaker_tpu_torch.utils.convert import (
    flax_variables_to_state_dict,
    random_normal_params,
    state_dict_to_flax_variables,
)

RTOL, ATOL = 1e-5, 1e-5
PARAM_ATOL = 2e-6
POSE, FRAMES, BASE, BATCH = 6, 34, 8, 16
LR, STEPS = 1e-3, 2
# biases that reach a train-mode BatchNorm through linear layers only, as a
# constant over the batch: their gradient is 0 in exact arithmetic (below 3e-16
# in f64 through the Flax module; every other gradient is above 1e-3)
ZERO_GRAD_BIASES = ("encoder/conv0/bias", "encoder/conv1/bias", "encoder/conv2/bias",
                    "encoder/conv3/bias", "encoder/fc0/bias", "encoder/fc0_bn/bias",
                    "encoder/fc1/bias", "encoder/fc1_bn/bias", "encoder/fc2/bias",
                    "encoder/fc_mu/bias", "decoder/pre0/bias",
                    "decoder/deconv0/bias", "decoder/deconv1/bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: ATen splits transcendentals (the GRU's sigmoid
    and tanh) over threads above its grain size, and the first such split
    of a process can come back less accurate; one thread keeps every
    element on the calling thread's path."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, rtol=RTOL, atol=ATOL, msg=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _tree_close(port, ref, rtol=RTOL, atol=ATOL):
    flat_p = jax.tree_util.tree_flatten_with_path(port)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_p) == len(flat_r)
    for path, a in flat_p:
        _close(a, flat_r[path], rtol, atol, msg=jax.tree_util.keystr(path))


def _randomised(variables, rng):
    """Unit-fan-in weights; running means in [0.1, 0.5), variances in
    [1.1, 1.5)."""
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (float(jax.tree_util.keystr(path).endswith("['var']"))
                         + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        jax.device_get(variables.get("batch_stats", {})))
    return {"params": random_normal_params(jax.device_get(variables["params"]), rng),
            "batch_stats": stats}


def _carried(jmodel, tmodel, *inputs, seed=0):
    """Flax variables of ``jmodel`` (randomised) and ``tmodel`` loaded with
    them."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(seed),
                                                *map(jnp.asarray, inputs), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    v = _randomised(zeros, np.random.default_rng(seed + 1))
    tmodel.load_state_dict(flax_variables_to_state_dict(v, tmodel))
    return v


def _apply(jmodel, v, *inputs, train):
    """The Flax module in train mode (with its new batch statistics) or eval
    mode, compiled once."""
    if train:
        fn = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=True, mutable=["batch_stats"]))
        out, upd = fn(v, *map(jnp.asarray, inputs))
        return out, jax.device_get(upd["batch_stats"])
    fn = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))
    return fn(v, *map(jnp.asarray, inputs)), v["batch_stats"]


def _run_port(tmodel, *inputs, train):
    tmodel.train(train)
    out = tmodel(*map(torch.from_numpy, inputs))
    return out, state_dict_to_flax_variables(tmodel.state_dict(), tmodel)["batch_stats"]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return {
        "poses": (rng.normal(size=(BATCH, FRAMES, POSE)) + 0.5).astype(np.float32),
        "latent": rng.normal(size=(BATCH, BASE)).astype(np.float32),
        "pre": rng.normal(size=(BATCH, 4, POSE)).astype(np.float32),
    }


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(BATCH, 24), (BATCH, FRAMES, 24)], ids=["2d", "3d"])
def test_batchnorm_matches_flax(train, shape):
    from flax import linen as nn

    rng = np.random.default_rng(4)
    x = (3.0 + 2.0 * rng.normal(size=shape)).astype(np.float32)  # a mean far from 0
    jbn = nn.BatchNorm(use_running_average=not train)
    v = _randomised(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    bn = T.BatchNorm(24)
    bn.load_state_dict({"weight": torch.tensor(v["params"]["scale"]),
                        "bias": torch.tensor(v["params"]["bias"]),
                        "mean": torch.tensor(v["batch_stats"]["mean"]),
                        "var": torch.tensor(v["batch_stats"]["var"])})
    bn.train(train)
    xt = torch.from_numpy(x).movedim(-1, 1)  # channels on dim 1
    out = bn(xt).movedim(1, -1)
    if train:
        ref, upd = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        _close(bn.mean, upd["batch_stats"]["mean"])
        _close(bn.var, upd["batch_stats"]["var"])
    else:
        ref = jbn.apply(v, jnp.asarray(x))
    _close(out, ref)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_conv_decoder_matches_flax(inputs, train):
    """``PoseEmbeddingDecoder``: its transposed convs carry over with the tap
    axis flipped."""
    jm = J.PoseEmbeddingDecoder(pose_dim=POSE, n_frames=FRAMES, base=BASE)
    tm = T.PoseEmbeddingDecoder(POSE, FRAMES, BASE)
    v = _carried(jm, tm, inputs["latent"])
    ref, ref_stats = _apply(jm, v, inputs["latent"], train=train)
    out, stats = _run_port(tm, inputs["latent"], train=train)
    assert out.shape == (BATCH, FRAMES, POSE)
    _close(out, ref)
    _tree_close(stats, ref_stats)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("pre_poses", [False, True], ids=["latent", "latent_and_seed"])
def test_fc_decoder_matches_flax(inputs, train, pre_poses):
    jm = J.PoseDecoderFC(gen_length=FRAMES, pose_dim=POSE, use_pre_poses=pre_poses)
    tm = T.PoseDecoderFC(FRAMES, POSE, pre_poses, latent_dim=BASE)
    args = (inputs["latent"], inputs["pre"]) if pre_poses else (inputs["latent"],)
    v = _carried(jm, tm, *args)
    ref, ref_stats = _apply(jm, v, *args, train=train)
    out, stats = _run_port(tm, *args, train=train)
    _close(out, ref)
    _tree_close(stats, ref_stats)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_gru_decoder_matches_flax(inputs, train):
    """The bidirectional GRU at hidden 7 over 2 layers: Flax's cells
    GRUCell_{2i} / GRUCell_{2i+1} into torch's nn.GRU."""
    jm = J.PoseDecoderGRU(gen_length=FRAMES, pose_dim=POSE, hidden=7, num_layers=2)
    tm = T.PoseDecoderGRU(FRAMES, POSE, hidden=7, num_layers=2, latent_dim=BASE)
    v = _carried(jm, tm, inputs["latent"], inputs["pre"])
    ref, ref_stats = _apply(jm, v, inputs["latent"], inputs["pre"], train=train)
    out, stats = _run_port(tm, inputs["latent"], inputs["pre"], train=train)
    _close(out, ref)
    _tree_close(stats, ref_stats)


def test_gru_decoder_full_size_shapes(inputs):
    """hidden 300, 4 layers, latent 32: the port's state_dict holds exactly
    Flax's tree (shapes from ``jax.eval_shape``, nothing compiled), and the
    output is [B, 34, 27]."""
    jm = J.PoseDecoderGRU()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32)),
                                            jnp.zeros((2, 4, 27)), train=False))
    tm = T.PoseDecoderGRU()
    tree = state_dict_to_flax_variables(tm.state_dict(), tm)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tree) == \
           jax.tree_util.tree_map(lambda a: tuple(a.shape), jax.device_get(shapes))
    tm.eval()
    out = tm(torch.zeros(2, 32), torch.zeros(2, 4, 27))
    assert out.shape == (2, 34, 27)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_gesture_autoencoder_matches_flax(inputs, train):
    """The encoder with trainable BatchNorm and the conv decoder: feat,
    recon and the batch statistics after the call; ``embed`` on the running
    statistics in either mode."""
    jm = J.GestureAutoencoder(pose_dim=POSE, n_frames=FRAMES, base=BASE)
    tm = T.GestureAutoencoder(POSE, FRAMES, BASE)
    v = _carried(jm, tm, inputs["poses"])
    (ref_feat, ref_recon), ref_stats = _apply(jm, v, inputs["poses"], train=train)
    (feat, recon), stats = _run_port(tm, inputs["poses"], train=train)
    _close(feat, ref_feat)
    _close(recon, ref_recon)
    _tree_close(stats, ref_stats)
    emb = jax.jit(lambda v, x: jm.apply(v, x, method=jm.embed))(v, jnp.asarray(inputs["poses"]))
    tm.load_state_dict(flax_variables_to_state_dict(v, tm))
    tm.train(train)
    _close(tm.embed(torch.from_numpy(inputs["poses"])), emb)
    assert tm.encoder.training == train


def test_weight_bridge_round_trips():
    """Flax variables -> state_dict -> Flax variables gives the same bits,
    for the autoencoder, the seeded-FC decoder and the GRU decoder."""
    for jm, tm, args in (
            (J.PoseDecoderGRU(hidden=7, num_layers=2), T.PoseDecoderGRU(hidden=7, num_layers=2),
             (np.zeros((2, 32), np.float32), np.zeros((2, 4, 27), np.float32))),
            (J.GestureAutoencoder(pose_dim=POSE, base=BASE), T.GestureAutoencoder(POSE, base=BASE),
             (np.zeros((2, FRAMES, POSE), np.float32),)),
            (J.PoseDecoderFC(pose_dim=POSE, use_pre_poses=True),
             T.PoseDecoderFC(pose_dim=POSE, use_pre_poses=True),
             (np.zeros((2, 32), np.float32), np.zeros((2, 4, POSE), np.float32)))):
        v = _carried(jm, tm, *args)
        _tree_close(state_dict_to_flax_variables(tm.state_dict(), tm), v, rtol=0, atol=0)


@pytest.fixture(scope="module")
def optax_steps(inputs):
    """STEPS Adam steps of the Flax autoencoder on the reconstruction MSE
    (the JAX script's train_step, compiled once): the variables before and
    after, and the losses."""
    jm = J.GestureAutoencoder(pose_dim=POSE, n_frames=FRAMES, base=BASE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(inputs["poses"]),
                                            train=True))
    v = _randomised(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes),
                    np.random.default_rng(5))
    tx = optax.adam(LR)

    @jax.jit
    def step(params, batch_stats, opt_state, poses):
        def loss_fn(p):
            (_, recon), upd = jm.apply({"params": p, "batch_stats": batch_stats}, poses,
                                       train=True, mutable=["batch_stats"])
            return jnp.mean((recon - poses) ** 2), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    params, stats = v["params"], v["batch_stats"]
    opt_state, losses = tx.init(params), []
    rng = np.random.default_rng(6)
    batches = [inputs["poses"]] + [(rng.normal(size=inputs["poses"].shape) + 0.5)
                                   .astype(np.float32) for _ in range(STEPS - 1)]
    for poses in batches:
        params, stats, opt_state, loss = step(params, stats, opt_state, jnp.asarray(poses))
        losses.append(float(loss))
    return v, batches, jax.device_get({"params": params, "batch_stats": stats}), losses


def test_two_adam_steps_match_optax(optax_steps):
    """torch.optim.Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8) on the carried weights, the same batches: the losses, the batch
    statistics and the parameters after STEPS steps."""
    before, batches, ref, ref_losses = optax_steps
    tm = T.GestureAutoencoder(POSE, FRAMES, BASE)
    tm.load_state_dict(flax_variables_to_state_dict(before, tm))
    tm.train()
    opt = torch.optim.Adam(tm.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for poses in batches:
        x = torch.from_numpy(poses)
        loss = torch.mean((tm(x)[1] - x) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=RTOL)
    after = state_dict_to_flax_variables(tm.state_dict(), tm)
    mean_atol = ATOL + 0.01 * 2 * (STEPS - 1) * LR
    for path, a in jax.tree_util.tree_flatten_with_path(after["batch_stats"])[0]:
        ref_a = dict(jax.tree_util.tree_flatten_with_path(ref["batch_stats"])[0])[path]
        key = jax.tree_util.keystr(path)
        _close(a, ref_a, atol=mean_atol if key.endswith("['mean']") else ATOL, msg=key)
    flat = lambda t: {jax.tree_util.keystr(p).replace("']['", "/").strip("[]'"): np.asarray(a)
                      for p, a in jax.tree_util.tree_flatten_with_path(t)[0]}
    port, ref_p, start = flat(after["params"]), flat(ref["params"]), flat(before["params"])
    assert sorted(port) == sorted(ref_p) and set(ZERO_GRAD_BIASES) <= set(port)
    for name in port:
        if name in ZERO_GRAD_BIASES:
            for side in (port[name], ref_p[name]):
                assert np.abs(side - start[name]).max() <= STEPS * LR * (1 + 1e-5), name
        else:
            _close(port[name], ref_p[name], rtol=0, atol=PARAM_ATOL, msg=name)


def test_train_gesture_autoencoder_on_the_cpu(tmp_path):
    """The script end to end on synthetic records with ``--device cpu``:
    finite reconstruction MSEs, and an npz in the JAX script's layout that
    the Flax module applies and the port loads strictly."""
    data = str(tmp_path / "records")
    build_synthetic_ted_records(data, n_clips=2, clip_seconds=8, seed=2)
    out = train_gesture_autoencoder.main(
        ["--device", "cpu", "--data_dir", data, "--batch_size", "8", "--epochs", "2",
         "--base", str(BASE), "--lr", "1e-3", "--log_interval", "1",
         "--save_dir", str(tmp_path / "ae")])
    assert out["step"] > 2 and len(out["losses"]) == out["step"]
    assert np.isfinite(out["losses"]).all()
    assert os.path.basename(out["path"]) == f"gesture_ae{out['step']:09d}.npz"
    tree = load_params_npz(out["path"])
    assert sorted(tree) == ["batch_stats", "params"]
    jm = J.GestureAutoencoder(base=BASE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 34, 27)),
                                            train=False))
    tree_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert tree_shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                 jax.device_get(shapes))
    tm = T.GestureAutoencoder(base=BASE)
    tm.load_state_dict(flax_variables_to_state_dict(tree, tm))
    poses = np.random.default_rng(0).normal(size=(4, 34, 27)).astype(np.float32)
    feat = jax.jit(lambda v, x: jm.apply(v, x, method=jm.embed))(tree, jnp.asarray(poses))
    _close(tm.embed(torch.from_numpy(poses)), feat)


def test_npz_layout_manifest_is_the_flax_tree(tmp_path):
    """``tests/manifests/gesture_ae_ted.json`` (what ``chip_smoke.py``
    holds the card's npz to, without JAX) lists the Flax module's flat
    keys and shapes at TED's width, base 32, and the port's writer gives
    exactly those."""
    with open(os.path.join(os.path.dirname(__file__), "manifests", "gesture_ae_ted.json")) as f:
        manifest = {k: tuple(v) for k, v in json.load(f).items()}
    jm = J.GestureAutoencoder()
    shapes = jax.device_get(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 34, 27)), train=False)))
    flat = {jax.tree_util.keystr(p).replace("']['", "/").strip("[]'"): tuple(a.shape)
            for p, a in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert flat == manifest
    path = str(tmp_path / "ae.npz")
    train_gesture_autoencoder.save_autoencoder_npz(path, T.GestureAutoencoder())
    with np.load(path) as z:
        assert {k: z[k].shape for k in z.files} == manifest


def test_train_gesture_autoencoder_refusals(tmp_path):
    for flags in (["--ema_rate", "0.99"], ["--ema_warmup"], ["--pipeline_parallel", "2"]):
        with pytest.raises(SystemExit):
            train_gesture_autoencoder.parse_args(flags)


def test_tensorboard_platform_writes_events(tmp_path):
    tb = TensorboardPlatform(str(tmp_path))
    tb.report_scalar("loss", 1.0, iteration=1, group_name="Loss")
    tb.close()
    assert glob.glob(str(tmp_path / "events.out.tfevents.*"))


def test_clearml_platform_needs_its_package(tmp_path):
    try:
        import clearml  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            ClearmlPlatform(str(tmp_path))
