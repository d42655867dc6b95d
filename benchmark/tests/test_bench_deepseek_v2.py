"""A tiny DeepSeek-V2 configuration through ``cell.run`` on the CPU, as
the toy architecture runs: its plug-in, reference and the port's module,
loaded by the configuration's ``arch``. A sound run is ``correct``; the
reference computed in float8 in the program's place is not; a program
whose MoE layers leave out the shared experts is not.

The geometry is the CPU tests' (hidden 64, one dense and two MoE layers,
8 routed experts, top 2, 2 shared, ``kv_lora_rank`` 32, rope 16), the
corpus 64 partitions at D=64. Its ``score_gap`` limit is this test's own,
0.025: at two experts a token a routing flip under bf16 rounding can move
a tiny model's embedding more than one of the published 6 of 64 experts
does (sound 0.0028 and float8 0.0520 on this seed, read on the CPU); the
configuration's own limit is calibrated on the card."""

from __future__ import annotations

import time

from benchmark import cell, encoders

TINY_ENCODER = dict(vocab_size=10400, hidden_size=64, num_hidden_layers=3, first_k_dense_replace=1,
                    intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
                    n_shared_experts=2, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                    qk_rope_head_dim=16, v_head_dim=16)
LIMIT = 0.025


def tiny_spec():
    spec = cell.load_spec("deepseek-v2-lite.bulk-256")
    spec.config["encoder"].update(TINY_ENCODER)
    spec.config["serving"]["store_workers"] = 2
    spec.config["checks"]["score_gap"] = LIMIT
    return spec


def test_tiny_deepseek_v2_cell_is_correct_and_its_control_and_fault_are_not(tiny_scale, monkeypatch):
    scale = dict(tiny_scale, corpus=dict(tiny_scale["corpus"], dim=64),
                 traffic=dict(tiny_scale["traffic"], batch=16))
    spec = tiny_spec()
    sound = cell.run(spec, 2**31 + 77, 1.0, True, "cpu", time.perf_counter(), scale=scale, control=True)
    assert sound["line"]["correct"], sound["line"]["checks"]
    assert sound["control"]["score_gap"] > LIMIT, sound["control"]
    metrics = sound["line"]["metrics"]
    assert metrics["expert_load.dsv2"]["value"] >= 1.0 and metrics["forward_ms.dsv2"]["value"] > 0

    plugin = encoders.load(spec.config["encoder"])
    build = plugin.build_model

    def shared_left_out(torch, enc, seed, device):
        model = build(torch, enc, seed, device)
        with torch.no_grad():
            for lp in model.layers:
                if lp.moe:
                    lp.shared_down_proj.zero_()
        return model

    monkeypatch.setattr(plugin, "build_model", shared_left_out)
    broken = cell.run(tiny_spec(), 2**31 + 77, 1.0, False, "cpu", time.perf_counter(), scale=scale)
    assert not broken["line"]["correct"], broken["line"]["checks"]
