"""The language model text tower (``models/moe_text.py``: DeepSeek-V3's
layer, as Moonlight-16B-A3B runs it) against the benchmark's plain
reference (``benchmark/reference/moe_text.py``) at a tiny size on the CPU:
hidden 64, 3 layers of which the first is dense, 8 routed experts with 2
chosen a token and 1 shared, vocab 512. The weights are seeded by the
benchmark's own rule (``benchmark/weights_lm.py``) and taken in place by a
module built on the meta device, as the benchmark's cell does.

Features with the reference's own routing and with the port's routing
forced on it; a sentence alone and in a padded batch; the routing weights;
the expert-load counters; the pipeline's sketch from this tower against
``reference.text.sag_decode``; its spans; the refusal on a mesh; the
checkpoint name map.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark.reference import moe_text as ref
from benchmark.reference import text as ref_text
from benchmark.weights import seeded_tensors, shapes_of
from benchmark.weights_lm import seeded_tensors as seeded_lm
from livelyspeaker_tpu_torch.models import SAG, RAG, MoETextConfig, MoETextEncoder, RAGConfig
from livelyspeaker_tpu_torch.parallel import create_mesh
from livelyspeaker_tpu_torch.pipeline import LivelySpeakerPipeline
from livelyspeaker_tpu_torch.utils import profiling
from livelyspeaker_tpu_torch.utils.convert import moe_text_state_dict_from_hf

CFG = MoETextConfig(vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
                    num_experts_per_tok=2, n_shared_experts=1, out_dim=32)
# f32 on both sides; the port packs the real tokens and sums the chosen
# experts in one product, the reference pads each block and adds expert by
# expert, so the same products are summed in other orders: a few f32
# roundings through three layers (measured below 1e-6 of max |z|)
TOL = 1e-5
LENGTHS = [11, 4, 6, 1, 9]
SAG_CFG = dict(njoints=9, nfeats=3, latent_dim=32, ff_size=64, num_layers=1, num_heads=2,
               n_pre_poses=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's CPU thread pool costs more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tower(seed=5):
    """The tower on seeded weights, and those weights (the reference's)."""
    with torch.device("meta"):
        tower = MoETextEncoder(CFG)
    w = seeded_lm(shapes_of(tower), seed, "moe_text", "cpu")
    tower.load_state_dict(w, assign=True)
    return tower.eval(), w


def _ids(seed=0, lengths=LENGTHS):
    """ids [B, longest]: uniform ids, pad positions filled with other ids
    (the tower must not read them)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, (len(lengths), max(lengths)), generator=g)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@torch.no_grad()
def test_features_match_the_reference_on_its_own_routing():
    tower, w = _tower()
    ids = _ids()
    z, routing = tower(ids, LENGTHS, return_routing=True)
    z_ref, own, margin = ref.forward(w, dataclasses.asdict(CFG), ids, LENGTHS, block=2)
    assert z.shape == (len(LENGTHS), CFG.out_dim)
    assert routing.dtype == torch.uint8
    assert routing.shape == (CFG.n_moe_layers, sum(LENGTHS), CFG.num_experts_per_tok)
    assert torch.equal(routing.sort(-1).values, own.sort(-1).values)
    assert margin == 0.0
    assert _rel(z, z_ref) < TOL


@torch.no_grad()
def test_features_match_the_reference_following_the_routing():
    """The reference follows the port's routing, weighted by its own
    scores; a routing that is not the reference's own shows in its margin
    and moves the features."""
    tower, w = _tower()
    ids = _ids()
    z, routing = tower(ids, LENGTHS, return_routing=True)
    cfg = dataclasses.asdict(CFG)
    z_ref, followed, margin = ref.forward(w, cfg, ids, LENGTHS, routing=routing, block=3)
    assert torch.equal(followed, routing) and margin == 0.0
    assert _rel(z, z_ref) < TOL
    shifted = (routing.long() + 1) % CFG.n_routed_experts
    z_moved, _, margin = ref.forward(w, cfg, ids, LENGTHS, routing=shifted)
    assert margin > 0.0
    assert _rel(z_moved, z_ref) > 100 * TOL


@torch.no_grad()
def test_a_sentence_alone_and_in_a_padded_batch():
    tower, _ = _tower()
    ids = _ids(seed=1)
    z = tower(ids, LENGTHS)
    for i, n in enumerate(LENGTHS):
        alone = tower(ids[i:i + 1, :n], [n])
        assert _rel(alone[0], z[i]) < TOL, i
    # ids on the tower's device, lengths as a tensor: the same features
    assert _rel(tower(ids.clone(), torch.tensor(LENGTHS)), z) < TOL


def test_lengths_that_do_not_fit_are_refused():
    tower, _ = _tower()
    ids = _ids()
    for lengths in ([0] + LENGTHS[1:], [12] + LENGTHS[1:], LENGTHS[:-1]):
        with pytest.raises(ValueError, match="do not fit"):
            tower(ids, lengths)


@torch.no_grad()
def test_chosen_weights_sum_to_the_scaling_factor():
    tower, _ = _tower()
    moe = tower.layers[1].mlp
    y = torch.randn(40, CFG.hidden_size, generator=torch.Generator().manual_seed(3))
    load = torch.zeros(CFG.n_routed_experts, dtype=torch.long)
    top, w, order, rows, sizes = moe.route(y, load)
    assert torch.allclose(w.sum(-1), torch.full((40,), CFG.routed_scaling_factor),
                          rtol=1e-6, atol=0)
    assert (w > 0).all() and top.shape == (40, CFG.num_experts_per_tok)
    assert sizes == load.tolist() and sum(sizes) == 40 * CFG.num_experts_per_tok
    # the rows are y's, sorted by expert
    expert = top.reshape(-1)[order]
    assert (expert[1:] >= expert[:-1]).all()
    assert torch.equal(rows, y[order // CFG.num_experts_per_tok])


@torch.no_grad()
def test_counters_count_each_real_token_k_times_a_layer():
    tower, _ = _tower()
    tower(_ids(), LENGTHS)
    before = np.array(profiling.counters()["moe_text"]["expert_load"])
    tower(_ids(seed=2), LENGTHS)
    load = np.array(profiling.counters()["moe_text"]["expert_load"]) - before
    assert load.shape == (CFG.n_moe_layers, CFG.n_routed_experts)
    assert (load.sum(1) == sum(LENGTHS) * CFG.num_experts_per_tok).all()


class _Tokens:
    """Seeded ids a sentence, as many as its words times two."""

    def __call__(self, sentences):
        rows = [torch.randint(0, CFG.vocab_size, (2 * len(s.split()),),
                              generator=torch.Generator().manual_seed(len(s))).numpy()
                for s in sentences]
        lengths = np.array([len(r) for r in rows])
        ids = np.zeros((len(rows), lengths.max()), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        return ids, lengths


SENTENCES = ["so we went down to the river", "she never expected that", "yes"]


def _pipeline(tower, mesh=None):
    rag = RAG(RAGConfig.ted(latent_dim=32, num_layers=1, n_speakers=4),
              generator=torch.Generator().manual_seed(0))
    sag = SAG(**SAG_CFG)
    sag_w = seeded_tensors(shapes_of(sag), 7, "sag", "cpu")
    sag.load_state_dict(sag_w)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    return LivelySpeakerPipeline(rag, sag, tower, _Tokens(), **kw), sag_w


def test_pipeline_sketch_matches_the_reference():
    tower, w = _tower()
    pipe, sag_w = _pipeline(tower)
    seed = torch.randn(3, 9, 3, 34, generator=torch.Generator().manual_seed(4))
    sketch = pipe.semantic_sketch(SENTENCES, seed)
    ids, lengths = _Tokens()(SENTENCES)
    with torch.no_grad():
        z, _, _ = ref.forward(w, dataclasses.asdict(CFG), torch.from_numpy(ids), lengths)
        want = ref_text.sag_decode(sag_w, SAG_CFG, z, seed)
    assert sketch.shape == seed.shape
    assert _rel(sketch, want) < TOL


def test_pipeline_records_the_tower_spans(tmp_path):
    """``compose.lm`` around the tower, then ``compose.sag``; inside it
    each layer's ``lm.attn``, then ``lm.ffn`` (dense) or ``lm.route`` and
    ``lm.ffn`` (routed)."""
    tower, _ = _tower()
    pipe, _ = _pipeline(tower)
    seed = torch.randn(3, 9, 3, 34)
    with profiling.device_trace(str(tmp_path)):
        pipe.semantic_sketch(SENTENCES, seed)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    names = [n for _, _, n in spans]
    assert names == (["compose.lm", "lm.attn", "lm.ffn"] + ["lm.attn", "lm.route", "lm.ffn"] * 2
                     + ["compose.sag"])
    lm_end = spans[0][0] - spans[0][1]
    assert all(ts - neg <= lm_end for ts, neg, _ in spans[1:-1])
    assert spans[-1][0] >= lm_end


def test_a_mesh_is_refused():
    tower, _ = _tower()
    with pytest.raises(ValueError, match="not replicated"):
        _pipeline(tower, mesh=create_mesh(devices=["cpu", "cpu"]))


def test_config_reads_the_benchmark_configuration():
    """Moonlight's ``config.json`` keys give the published sizes; a setting
    the tower does not compute is refused."""
    with open("benchmark/configs/livelyspeaker-beat-moonlight.json") as f:
        cfg = json.load(f)
    c = MoETextConfig.from_hf(cfg, out_dim=cfg["text_tower"]["out_dim"])
    assert c == MoETextConfig()
    with torch.device("meta"):
        n = sum(p.numel() for p in MoETextEncoder(c).parameters())
    assert n == cfg["text_tower"]["parameters"]
    for k, v in (("scoring_func", "softmax"), ("q_lora_rank", 1536), ("topk_group", 0)):
        with pytest.raises(ValueError):
            MoETextConfig.from_hf({**cfg, k: v})


def test_checkpoint_names_map_onto_the_tower():
    """A synthetic DeepSeek-V3 state dict under the released names: the
    experts stacked in order, ``lm_head`` dropped, the rest renamed; it
    loads into the tower with the adapter alone missing."""
    tower, w = _tower()
    hf = {"lm_head.weight": torch.zeros(CFG.vocab_size, CFG.hidden_size)}
    for name, value in w.items():
        if name.startswith("adapter."):
            continue
        if ".mlp.experts." in name:
            layer, kind = name.split(".mlp.experts.")
            for e in range(CFG.n_routed_experts):
                hf[f"model.{layer}.mlp.experts.{e}.{kind}.weight"] = value[e].clone()
        else:
            hf["model." + name] = value.clone()
    sd = moe_text_state_dict_from_hf(hf)
    assert "lm_head.weight" not in sd
    assert set(sd) == {k for k in w if not k.startswith("adapter.")}
    assert all(torch.equal(sd[k], w[k]) for k in sd)
    missing = MoETextEncoder(CFG).load_state_dict(sd, strict=False).missing_keys
    assert sorted(missing) == ["adapter.bias", "adapter.weight"]
    del hf["model.layers.2.mlp.experts.3.up_proj.weight"]
    with pytest.raises(ValueError, match="experts"):
        moe_text_state_dict_from_hf(hf)
