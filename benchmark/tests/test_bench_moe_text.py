"""The language model composition cell's own parts: its FLOP count pinned
at the cell's sizes, its weights' rule for stacked experts, and the cell
end to end at a tiny size on the CPU, ``correct`` on the program and not
correct with the tower broken underneath."""

import copy
import math
import time

import pytest
import torch

from benchmark import arith_lm, harness, weights
from benchmark.weights_lm import scale_rule, seeded_tensors

from .conftest import TINY_CONFIG

CELL = "beat-compose-moonlight-b64"
TINY_TOWER = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                  kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
                  num_experts_per_tok=2, n_shared_experts=1)
TINY_TRAFFIC = dict(batch=3, respacing="ddim10", skip=7, audio_pool=8, trace_units=1,
                    check_batches=2, tokens=[3, 12])


def _config():
    spec = harness.load_spec()
    return harness.load_json(harness.config_file(spec, harness.find_cell(spec, CELL)["config"]))


# Moonlight's sizes, by hand: a real token's products a layer in MLA
# (2 * 2048 * (16 * 192 + 512 + 64) + 2 * 512 * 16 * 256 + 2 * 16 * 128 * 2048)
# over 27 layers; the router, 26 * 2 * 2048 * 64; the SwiGLUs,
# 6 * 2048 * (11264 + 26 * (6 + 2) * 1408); a causal (query, key) pair,
# 27 * 2 * 16 * (192 + 128); a sentence's adapter, 2 * 2048 * 512.
PER_TOKEN = 27 * 27_525_120 + 6_815_744 + 3_737_124_864
PER_PAIR = 276_480
PER_SENTENCE = 2_097_152


def test_tower_flops_at_the_cell_sizes():
    cfg = _config()
    assert PER_TOKEN == 4_487_118_848  # 4.49 GFLOP a real token, 2.24B active parameters
    one = arith_lm.tower_flops(cfg, [1])
    assert one["total"] == PER_TOKEN + PER_PAIR + PER_SENTENCE
    got = arith_lm.tower_flops(cfg, [32, 256])
    assert got["total"] == 288 * PER_TOKEN + (528 + 32_896) * PER_PAIR + 2 * PER_SENTENCE
    assert got["ffn"] == 288 * 3_737_124_864
    assert got["route"] == 288 * 6_815_744
    assert got["attn"] + got["route"] + got["ffn"] + got["adapter"] == got["total"]
    # a batch of 64 sentences of the traffic's mean length (108): ~31 TFLOP
    assert 30e12 < arith_lm.tower_flops(cfg, [108] * 64)["total"] < 32e12


def test_stacked_experts_scale_by_their_last_dimension():
    """``weights.py``'s rule takes the product of the trailing sizes as the
    fan-in, wrong for [E, out, in]; ``weights_lm`` takes the last."""
    fan_in = lambda name, shape: scale_rule(name, shape)[0] ** -2
    assert fan_in("layers.1.mlp.experts.gate_proj", (64, 1408, 2048)) == pytest.approx(2048)
    assert fan_in("layers.1.mlp.experts.down_proj", (64, 2048, 1408)) == pytest.approx(1408)
    assert weights._rule("layers.1.mlp.experts.gate_proj", (64, 1408, 2048))[0] ** -2 == \
        pytest.approx(1408 * 2048)
    assert fan_in("layers.0.self_attn.q_proj.weight", (3072, 2048)) == pytest.approx(2048)
    assert scale_rule("layers.3.input_layernorm.weight", (2048,)) == (0.1, 1.0)
    assert scale_rule("layers.3.mlp.gate.e_score_correction_bias", (64,)) == (0.02, 0.0)
    assert scale_rule("adapter.bias", (512,)) == (0.02, 0.0)
    assert scale_rule("embed_tokens.weight", (163840, 2048)) == (1.0, 0.0)


def test_seeded_tensors_are_views_of_one_draw():
    shapes = {"embed_tokens.weight": (64, 32), "layers.1.mlp.experts.gate_proj": (8, 96, 400),
              "layers.1.mlp.experts.down_proj": (8, 400, 96), "norm.weight": (4000,),
              "layers.1.mlp.gate.e_score_correction_bias": (4000,)}
    w = seeded_tensors(shapes, 2 ** 33 + 1, "moe_text", "cpu")
    assert len({t.untyped_storage().data_ptr() for t in w.values()}) == 1
    assert {k: tuple(v.shape) for k, v in w.items()} == shapes
    for name, std, mean in (("layers.1.mlp.experts.gate_proj", 400 ** -0.5, 0.0),
                            ("layers.1.mlp.experts.down_proj", 96 ** -0.5, 0.0),
                            ("norm.weight", 0.1, 1.0),
                            ("layers.1.mlp.gate.e_score_correction_bias", 0.02, 0.0)):
        assert float(w[name].std()) == pytest.approx(std, rel=0.05), name
        assert abs(float(w[name].mean()) - mean) < 0.1 * std, name
    again = seeded_tensors(shapes, 2 ** 33 + 1, "moe_text", "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not torch.equal(seeded_tensors(shapes, 7, "moe_text", "cpu")["norm.weight"],
                           w["norm.weight"])
    assert math.prod(shapes["embed_tokens.weight"]) == w["embed_tokens.weight"].numel()


def tiny_ctx(trace=False, seconds=0.6):
    spec = harness.load_spec()
    cfg = copy.deepcopy(_config())
    for group in ("rag", "sag"):
        cfg[group].update(TINY_CONFIG[group])
    cfg.update(TINY_TOWER)
    cfg["text_tower"]["out_dim"] = cfg["sag"]["latent_dim"]
    tr = harness.load_json(harness.BENCH_DIR / "workloads" / f"{CELL}.json")
    tr.update(TINY_TRAFFIC)
    return harness.make_ctx(spec, CELL, 2 ** 33 + 5, seconds, trace, torch.device("cpu"),
                            time.monotonic(), config=cfg, traffic=tr)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(trace):
    spec = harness.load_spec()
    ctx = tiny_ctx(trace=trace)
    out = harness.run_cell(ctx)
    assert out.correct, out.checks
    assert set(out.checks) == {"text_gap", "route_margin", "clip_gap"}
    assert out.attempted > 0 and out.failed == 0
    line = harness.result_line(spec, ctx, out)
    if not trace:
        assert set(line["metrics"]) == {"compose_clips_per_s", "setup_s"}
    else:  # no kernel ran; the counters alone are read
        assert set(line["metrics"]) == {"expert_skew.moonlight"}
        assert line["metrics"]["expert_skew.moonlight"]["value"] >= 1.0
    assert out.obs["flops_per_unit"]["batches"] > 0


def _break(monkeypatch, fault):
    from livelyspeaker_tpu_torch.models import moe_text

    if fault == "other_experts":  # each token's k-th choice swapped for its next-best
        def other(self, y, load):
            c, k = self.cfg, self.cfg.num_experts_per_tok
            s = torch.sigmoid(torch.nn.functional.linear(y, self.gate.weight))
            top = torch.topk(s + self.gate.e_score_correction_bias, k + 1, dim=-1).indices
            top = torch.cat([top[:, :k - 1], top[:, k:]], -1)
            w = s.gather(1, top)
            w = w / w.sum(-1, keepdim=True) * c.routed_scaling_factor
            pairs = top.reshape(-1)
            order = torch.argsort(pairs, stable=True)
            counts = torch.bincount(pairs, minlength=c.n_routed_experts)
            load += counts
            return top, w, order, y.index_select(0, order // k), counts.tolist()

        monkeypatch.setattr(moe_text._MoE, "route", other)
        return
    forward = moe_text.MoETextEncoder.forward

    def altered(self, *a, **kw):  # one feature altered where it is produced
        z, routing = forward(self, *a, **kw)
        z = z.clone()
        z[0, 0] += 0.01 * float(z.abs().max())
        return z, routing

    monkeypatch.setattr(moe_text.MoETextEncoder, "forward", altered)


@pytest.mark.parametrize("fault,check", [("other_experts", "route_margin"),
                                         ("altered_feature", "text_gap")])
def test_broken_tower_is_not_correct(monkeypatch, fault, check):
    _break(monkeypatch, fault)
    out = harness.run_cell(tiny_ctx())
    assert not out.correct, out.checks
    value, limit = out.checks[check]
    assert value > limit, out.checks
