"""The language model text tower (``models/moe_text.py``: DeepSeek-V3's
layer, as Moonlight-16B-A3B runs it) against the benchmark's plain
reference (``benchmark/reference/moe_text.py``) at a tiny size on the CPU:
hidden 64, 3 layers of which the first is dense, 8 routed experts with 2
chosen a token and 1 shared, vocab 512. The weights are seeded by the
benchmark's own rule (``benchmark/weights_lm.py``) and taken in place by a
module built on the meta device, as the benchmark's cell does.

Features with the reference's own routing and with the port's routing
forced on it; a sentence alone and in a padded batch; the routing weights
and the experts' counts; the expert-load and tile-row counters; the
experts' products from counts as a tensor or a list; the grouped SwiGLU's
plain version (``ops/grouped_swiglu.py``) against the per-expert loop it
replaced, with an empty expert, one expert holding every row, single-row
groups, ragged groups, no rows, and the shared and dense groups; the
pipeline's sketch from this tower against ``reference.text.sag_decode``;
its spans; the refusal on a mesh; the checkpoint name map.
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
from livelyspeaker_tpu_torch.ops import grouped_swiglu as grouped
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
    top, w, order, rows, counts = moe.route(y, load)
    assert torch.allclose(w.sum(-1), torch.full((40,), CFG.routed_scaling_factor),
                          rtol=1e-6, atol=0)
    assert (w > 0).all() and top.shape == (40, CFG.num_experts_per_tok)
    # the experts' sizes stay a tensor where the rows are: no read to the host
    assert isinstance(counts, torch.Tensor) and counts.device == y.device
    assert counts.tolist() == load.tolist() and int(counts.sum()) == 40 * CFG.num_experts_per_tok
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


def test_ffn_tile_rows_counts_each_experts_padded_rows():
    """A fresh tower's ``ffn_tile_rows`` after one call, one entry a routed
    layer: the rows the grouped SwiGLU's kernels computed. On the CPU the
    plain version runs and no kernel computes a padded row, so every entry
    stays 0 beside the pairs routed (``benchmark/metrics/ffn_pad.py`` then
    reads nothing); on the card ``tests/test_torch_cuda.py`` holds it to
    ``expert_load`` rounded up to whole row tiles."""
    tower, _ = _tower()
    tower(_ids(), LENGTHS)
    got = profiling.counters()["moe_text"]
    assert len(got["ffn_tile_rows"]) == len(got["expert_load"]) == CFG.n_moe_layers
    assert got["ffn_tile_rows"] == [0] * CFG.n_moe_layers
    assert all(sum(layer) > 0 for layer in got["expert_load"])


@pytest.mark.parametrize("as_list", [False, True], ids=["tensor", "list"])
def test_compute_takes_the_counts_as_a_tensor_or_a_list(as_list):
    """``_MoE.compute`` from ``route``'s output, the counts as ``route``
    leaves them (a tensor) or read to the host, against the per-expert loop
    plus the shared experts."""
    tower, _ = _tower()
    moe = tower.layers[1].mlp
    y = torch.randn(30, CFG.hidden_size, generator=torch.Generator().manual_seed(4))
    load = torch.zeros(CFG.n_routed_experts, dtype=torch.long)
    with torch.no_grad():
        top, w, order, rows, counts = moe.route(y, load)
        got = moe.compute(y, w, order, rows, counts.tolist() if as_list else counts)
        ex = moe.experts
        want = (_per_expert_loop(y, top, w, ex.gate_proj, ex.up_proj, ex.down_proj)
                + moe.shared_experts(y))
    assert _rel(got, want) < 1e-6


# --- the grouped SwiGLU's plain version (ops/grouped_swiglu.py) against the
# per-expert loop it replaces, and the kernels' arithmetic emulated

def _routing(case):
    """(tokens, top [T, k]) of a routing over 8 experts that gives the case's
    groups."""
    g = torch.Generator().manual_seed(11)
    if case == "an_empty_expert":  # expert 3 is never chosen
        top = torch.stack([torch.randperm(7, generator=g)[:2] for _ in range(50)])
        return top + (top >= 3).long()
    if case == "one_expert_holds_every_row":
        return torch.full((40, 1), 5)
    if case == "single_row_groups":
        return torch.randperm(8, generator=g)[:, None]
    # ragged: 1, 129, 255, 0, 300, 2, 127, 0 rows, none a whole number of tiles
    sizes = [1, 129, 255, 0, 300, 2, 127, 0]
    pairs = torch.cat([torch.full((n,), e) for e, n in enumerate(sizes)])
    return pairs[torch.randperm(pairs.numel(), generator=g)].view(-1, 2)


def _per_expert_loop(x, top, w, wg, wu, wd):
    """The tower's dispatch before the grouped kernels: the sizes on the
    host, three products an expert, the weighted combine by bmm."""
    t, k = top.shape
    order = torch.argsort(top.reshape(-1), stable=True)
    rows = x.index_select(0, order // k)
    sizes = torch.bincount(top.reshape(-1), minlength=wg.shape[0]).tolist()
    outs = []
    for e, r in enumerate(rows.split(sizes)):
        if r.shape[0]:
            h = torch.nn.functional.silu(r @ wg[e].T) * (r @ wu[e].T)
            outs.append(h @ wd[e].T)
    routed = torch.empty_like(rows).index_copy_(0, order, torch.cat(outs))
    return torch.bmm(w[:, None, :], routed.view(t, k, -1)).squeeze(1)


def _swiglu_weights(groups, n, k=16, seed=12):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(groups, n, k, generator=g) * k ** -0.5,
            torch.randn(groups, n, k, generator=g) * k ** -0.5,
            torch.randn(groups, k, n, generator=g) * n ** -0.5)


@pytest.mark.parametrize("case", ["an_empty_expert", "one_expert_holds_every_row",
                                  "single_row_groups", "ragged"])
def test_grouped_plain_matches_the_per_expert_loop(case):
    top = _routing(case)
    t, k = top.shape
    g = torch.Generator().manual_seed(13)
    x = torch.randn(t, 16, generator=g)
    w = torch.rand(t, k, generator=g) + 0.1
    wg, wu, wd = _swiglu_weights(8, 24)
    want = _per_expert_loop(x, top, w, wg, wu, wd)
    order = torch.argsort(top.reshape(-1), stable=True)
    counts = torch.bincount(top.reshape(-1), minlength=8)
    offsets = torch.nn.functional.pad(counts.cumsum(0), (1, 0))
    got = grouped.grouped_swiglu(x.index_select(0, order // k), wg, wu, wd, offsets,
                                 dest=order, scale=w.reshape(-1))
    assert got.shape == (t * k, 16)
    assert _rel(got.view(t, k, -1).sum(1), want) < 1e-6


@pytest.mark.parametrize("width", [24, 88], ids=["shared_group", "dense_group"])
def test_grouped_plain_one_group_matches_the_swiglu(width):
    g = torch.Generator().manual_seed(14)
    x = torch.randn(37, 16, generator=g)
    wg, wu, wd = _swiglu_weights(1, width)
    want = (torch.nn.functional.silu(x @ wg[0].T) * (x @ wu[0].T)) @ wd[0].T
    assert _rel(grouped.grouped_swiglu(x, wg, wu, wd), want) < 1e-6


def test_grouped_plain_refuses_offsets_that_do_not_split_the_rows():
    wg, wu, wd = _swiglu_weights(2, 24)
    x = torch.zeros(10, 16)
    for ends in ([0, 4, 9], [1, 4, 10], [0, 11, 10]):
        with pytest.raises(ValueError, match="do not split"):
            grouped.grouped_swiglu(x, wg, wu, wd, torch.tensor(ends))


def _tf32(x):
    """x rounded to TF32 as csrc/tf32_mma.cuh's to_tf32 rounds it (to
    nearest, ties away from zero)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _emulated_product(x, w, passes):
    """x @ w^T as the grouped kernels' wgmma take it: with three passes each
    operand is split, v = hi + lo, hi = tf32(v), lo = tf32(v - hi), and each
    stage of 32 k sums lo.hi + hi.lo + hi.hi (lo.lo left out), added into
    the running f32 sum; with one, each stage of tf32(x) tf32(w)^T."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    run = torch.zeros(x.shape[0], w.shape[0])
    for k0 in range(0, x.shape[1], 32):
        k = slice(k0, k0 + 32)
        stage = xh[:, k] @ wh[:, k].T
        if passes == 3:
            stage = stage + (xl[:, k] @ wh[:, k].T + xh[:, k] @ wl[:, k].T)
        run = run + stage
    return run


@pytest.mark.parametrize("passes,within", [(3, 1e-6), (1, None)])
def test_grouped_kernels_arithmetic_holds_f32_accuracy(passes, within):
    """The kernels' 3xTF32 SwiGLU, emulated, at the routed experts' widths
    (hidden 2,048, width 1,408): within 1e-6 of the f64 SwiGLU, as f32 is;
    one TF32 pass is not (some 3e-4 off)."""
    g = torch.Generator().manual_seed(15)
    x = torch.randn(48, 2048, generator=g)
    wg, wu, wd = (t[0] for t in _swiglu_weights(1, 1408, k=2048, seed=16))
    h = torch.nn.functional.silu(_emulated_product(x, wg, passes)) * _emulated_product(x, wu, passes)
    got = _emulated_product(h, wd, passes)
    xd = x.double()
    want = (torch.nn.functional.silu(xd @ wg.double().T) * (xd @ wu.double().T)) @ wd.double().T
    rel = _rel(got.double(), want)
    assert rel < within if within else rel > 1e-4


@pytest.mark.parametrize("groups", [1, 8])
def test_grouped_plain_takes_no_rows(groups):
    """No rows (every group empty): an empty result of the rows' width."""
    wg, wu, wd = _swiglu_weights(groups, 24)
    offsets = torch.zeros(groups + 1, dtype=torch.long) if groups > 1 else None
    got = grouped.grouped_swiglu(torch.zeros(0, 16), wg, wu, wd, offsets)
    assert got.shape == (0, 16)


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
