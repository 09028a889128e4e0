"""The port's ``scripts/generate.py`` against the JAX package's script.

Both scripts read the same RAG npz (latent 32, 1 block, with its args.json),
the same SAG npz and the same waveform, and one deterministic stub stands in
for the sampler (and the composition) of either package: a function of the
conditioning, the sentences, the guidance and the call number. What is
compared is the scripts' own work: the model options restored from
args.json, the audio window or the whole audio (``--long``, its windows
chained by their seed frames), the conditioning, the layouts and the npz,
bit for bit, for RAG-only, ``--sag_path`` and ``--long`` at TED, and
RAG-only at BEAT (emotion-conditioned). The JAX script runs once a case for
the module (``jax_runs``), its render recorded instead of drawn.

Then the port's script runs for real on ``--device cpu`` (the plain
versions of the kernels; ddim2): ``main`` writes the npz and renders the
TED clip to a GIF (there is no ffmpeg here).
"""

import os
import sys

import numpy as np
import pytest
import torch

from livelyspeaker_tpu_torch.models import SAG, RAG, RAGConfig
from livelyspeaker_tpu_torch.scripts import generate
from livelyspeaker_tpu_torch.training.checkpoints import save_args, save_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "rag": ("ted", []),
    "sag": ("ted", ["--sag_path", "{sag}", "--text", "we should protect the oceans"]),
    "long": ("ted", ["--long", "--speaker", "3"]),
    "beat": ("beat", ["--emotion", "2", "--speaker", "5"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """RAG checkpoints (TED and BEAT) with their args.json, a SAG, and a
    5 s waveform."""
    root = tmp_path_factory.mktemp("generate_files")
    out = {}
    for name, cfg, extra in (
            ("ted", RAGConfig.ted(latent_dim=32, num_layers=1, n_speakers=40), {}),
            ("beat", RAGConfig.beat(latent_dim=32, num_layers=1, n_speakers=30),
             {"njoints": 47, "nfeats": 6, "num_emotions": 8})):
        d = root / name
        d.mkdir()
        model = RAG(cfg, generator=torch.Generator().manual_seed(3))
        save_params_npz(str(d / "rag.npz"), model.state_dict(), model)
        save_args(str(d), {"latent_dim": 32, "layers": 1, "n_speakers": cfg.n_speakers,
                           **extra})
        out[name] = str(d / "rag.npz")
    sag = SAG(njoints=9, nfeats=3, latent_dim=512, generator=torch.Generator().manual_seed(4))
    out["sag"] = str(root / "sag.npz")
    save_params_npz(out["sag"], sag.state_dict(), sag)
    out["audio"] = str(root / "speech.npy")
    np.save(out["audio"], (0.1 * np.random.default_rng(5).normal(size=5 * 16000))
            .astype(np.float32))
    out["root"] = str(root)
    return out


def _argv(files, case, out):
    dataset, extra = CASES[case]
    return (["--model_path", files[dataset], "--audio", files["audio"], "--out", out]
            + [a.format(**files) for a in extra])


def _stub_motion(cond, guidance, calls, sentences=None):
    """A deterministic 'sample' of the conditioning: the seed frames, the
    audio's mean and the speaker (and emotion), the guidance, the sentence
    lengths and seeded noise by call number."""
    x = np.asarray(cond["origin_x"], np.float32)
    b = x.shape[0]
    per = (np.asarray(cond["audio"], np.float32).mean(-1)
           + 0.01 * np.asarray(cond["vid"], np.float32)
           + 0.001 * np.asarray(cond.get("emo", np.zeros(b)), np.float32))
    noise = np.random.default_rng(calls).normal(size=x.shape).astype(np.float32)
    out = 0.9 * x + per[:, None, None, None] + 0.05 * float(guidance) + 0.05 * noise
    if sentences is not None:
        out = out + 0.001 * np.asarray([len(s) for s in sentences], np.float32)[
            :, None, None, None]
    return torch.from_numpy(out.astype(np.float32))


class StubSampler:
    """Stands in for RAGSampler in either package: the model is the first
    argument in both."""

    def __init__(self, model, *args, **kw):
        self.model = model
        self.device = torch.device("cpu")
        self.calls = 0

    def __call__(self, cond, rng=None, *, guidance=1.5, **kw):
        self.calls += 1
        return _stub_motion(cond, guidance, self.calls)


class StubPipe:
    """Stands in for the composition in either package (JAX:
    ``LivelySpeakerPipeline(model, params, ...)``; the port:
    ``build_pipeline(args, rag, njoints, nfeats)``)."""

    def __init__(self, *args, **kw):
        model = next(a for a in args if hasattr(a, "cfg"))
        self.rag_sampler = StubSampler(model)
        self.calls = 0

    def __call__(self, sentences, cond, rng=None, *, guidance=1.5):
        self.calls += 1
        return _stub_motion(cond, guidance, self.calls, sentences)


@pytest.fixture(scope="module")
def jax_runs(files, tmp_path_factory):
    """The JAX script once a case, its sampler and composition stubbed and
    its render recorded: {case: (npz contents, render calls)}."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LS_TPU_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
        mp.syspath_prepend(os.path.join(REPO, "scripts"))
        import generate as j_generate
        from livelyspeaker_tpu.models import clip_text as j_clip_text

        class StubCLIP:  # the stubbed composition never reads the text tower
            def init(self, *a, **kw):
                return {"params": {}}

        mp.setattr(j_clip_text, "CLIPTextEncoder", StubCLIP)
        out_dir = tmp_path_factory.mktemp("jax_out")
        for case in CASES:
            renders = []
            with pytest.MonkeyPatch.context() as inner:
                inner.setattr(j_generate, "RAGSampler", StubSampler)
                inner.setattr(j_generate, "LivelySpeakerPipeline", StubPipe)
                inner.setattr(j_generate, "render_ted_clip",
                              lambda motion, path, **kw: renders.append((motion, path, kw)))
                out = str(out_dir / case)
                inner.setattr(sys, "argv", ["generate.py"] + _argv(files, case, out))
                j_generate.main()
            runs[case] = (dict(np.load(out + ".npz")), renders)
    return runs


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(case, files, jax_runs, tmp_path, monkeypatch):
    want, want_renders = jax_runs[case]
    renders = []
    monkeypatch.setattr(generate, "RAGSampler", StubSampler)
    monkeypatch.setattr(generate, "build_pipeline", StubPipe)
    monkeypatch.setattr(generate, "render_ted_clip",
                        lambda motion, path, **kw: renders.append((motion, path, kw)))
    out = str(tmp_path / case)
    path = generate.main(_argv(files, case, out) + ["--device", "cpu"])
    assert path == out + ".npz"
    got = dict(np.load(path))
    assert got.keys() == want.keys() == {"motion", "audio"}
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    frames = 75 if case == "long" else 34  # 5 s at 15 fps
    assert got["motion"].shape == (frames, 27 if CASES[case][0] == "ted" else 282)
    assert len(renders) == len(want_renders) == (0 if case == "beat" else 1)
    for (m, p, kw), (jm, jp, jkw) in zip(renders, want_renders):
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(kw.pop("audio"), jkw.pop("audio"))
        assert os.path.basename(p) == os.path.basename(jp) and kw == jkw


@pytest.mark.parametrize("case", list(CASES))
def test_generate_runs_on_the_cpu(case, files, tmp_path):
    """The real samplers and composition on the CPU through their plain
    versions (ddim2, the composition refining its last step): finite motion
    of the expected shape, and (main, TED) the rendered GIF."""
    small = ["--device", "cpu", "--fused", "--timestep_respacing", "ddim2",
             "--diffusion_steps", "20", "--skip_steps", "1"]
    argv = _argv(files, case, str(tmp_path / case)) + small
    if case == "rag":
        path = generate.main(argv)
        motion = np.load(path)["motion"]
        gif = str(tmp_path / "rag.gif")
        assert os.path.exists(gif) and os.path.getsize(gif) > 1000
    else:
        if case == "sag":  # a narrow text tower: the full one takes minutes here
            from livelyspeaker_tpu_torch.models import CLIPTextConfig, CLIPTextEncoder
            from livelyspeaker_tpu_torch.scripts import eval_common

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(eval_common, "load_clip", lambda args: CLIPTextEncoder(
                    CLIPTextConfig(width=32, layers=1, heads=4, embed_dim=512),
                    generator=torch.Generator().manual_seed(1)))
                motion, wav = generate.run(generate.parse_args(argv))
        else:
            motion, wav = generate.run(generate.parse_args(argv))
        assert wav.shape == ((5 * 16000,) if case == "long" else (36267,))
    frames = 75 if case == "long" else 34
    assert motion.shape == (frames, 27 if CASES[case][0] == "ted" else 282)
    assert np.isfinite(motion).all()
