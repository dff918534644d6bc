"""The Jamba2 Mini configuration: every number of the published config
but its cut depth, its reference laid out as the port's parameters at
full width, and its cell run through ``run_cell`` on the CPU at the
port's smoke scale, untraced and traced (its new readers read the
program's spans; the scan's roofline, which needs the kernel, reads
nothing there)."""

import dataclasses
import json
from pathlib import Path

import torch

from clutchbench import run, scan_work
from clutchbench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = "jamba2-mini-16l"
CELL = "jamba2-mini-16l.gen-5000x500"
M = Manifest(ROOT / "BENCHMARK.json")
KIND = M.kind("lm_routed")
LM = M.kind("lm")
REF = M.reference("lm_jamba")
TINY_MIX = {"slots": 4, "max_len": 40, "prompt_len": 24, "new_tokens": 8,
            "pool_per_s": 20, "check_sample": 4}
#: the port's model keys and the published config's
PUBLISHED = {"d_model": "hidden_size", "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads", "d_ff": "intermediate_size",
             "vocab": "vocab_size", "norm_eps": "rms_norm_eps",
             "ssm_d_state": "mamba_d_state", "ssm_d_conv": "mamba_d_conv",
             "ssm_expand": "mamba_expand",
             "tie_embeddings": "tie_word_embeddings"}


def _tiny_model() -> dict:
    full = KIND.model_config(M.config(CONFIG)["model"])
    return json.loads(json.dumps(dataclasses.asdict(full.reduced())))


def test_the_configuration_is_the_published_one_but_its_depth():
    cfg = M.config(CONFIG)
    pub, model = cfg["published"], cfg["model"]
    for key, v in pub.items():
        if key not in ("source", *cfg["reduced"]):
            assert cfg[key] == v, key
    assert cfg["reduced"] == ["num_hidden_layers"]
    assert (cfg["num_hidden_layers"], pub["num_hidden_layers"]) == (16, 32)
    assert model["num_layers"] == cfg["num_hidden_layers"]
    for mine, theirs in PUBLISHED.items():
        assert model[mine] == pub[theirs], mine
    pat = model["block_pattern"]
    assert len(pat) == pub["attn_layer_period"]
    assert [i for i, k in enumerate(pat) if k == "attn"] == [
        pub["attn_layer_offset"]]
    moe = model["moe"]
    assert moe["moe_layers"] == list(range(
        pub["expert_layer_offset"], len(pat), pub["expert_layer_period"]))
    assert (moe["num_experts"], moe["top_k"], moe["d_ff_expert"]) == (
        pub["num_experts"], pub["num_experts_per_tok"],
        pub["intermediate_size"])
    assert model["d_model"] // 16 == pub["mamba_dt_rank"]
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == cfg["reduced"]
    assert entry["source"] == cfg["source"]


def test_the_reference_lays_the_weights_out_as_the_port():
    """Names and shapes of the reference's layout equal the port's
    ``init_params`` tree at full width (the meta device: shapes only);
    26.05 B parameters."""
    from repro_torch.models import lm
    model = M.config(CONFIG)["model"]
    port = LM._flat(lm.init_params(KIND.model_config(model),
                                     torch.Generator(), "meta"))
    ref = REF.layout(model)
    assert sorted(port) == sorted(ref)
    for name, (shape, _) in ref.items():
        assert tuple(port[name].shape) == shape, name
    n = sum(t.numel() for t in port.values())
    assert 26.04e9 < n < 26.06e9


def test_the_tiny_run_agrees_with_the_reference():
    over = {"config": {"model": _tiny_model()}, "mix": TINY_MIX}
    res, found = run.run_cell(M, CELL, 2 ** 31 + 11, 0.4, False,
                              device="cpu", overrides=over)
    assert res["correct"], res["checks"]
    assert found["logit_gap"] < 1e-3 and found["token_gap"] < 1e-3
    assert found["logit_gap_median"] <= found["logit_gap"]
    assert found["dropped_share"] == 0.0
    assert found["tokens"] == 4 * 8 and res["failed"] == 0
    assert set(res["metrics"]) == {"gen_tokens_per_s", "setup_s"}
    res, _ = run.run_cell(M, CELL, 2 ** 31 + 12, 8.0, True, device="cpu",
                          overrides={**over, "mix": {**TINY_MIX,
                                                     "trace_calls": [1, 3]}})
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert {"mamba_us.gen", "moe_us.gen", "launches_per_step.gen",
            "device_idle.gen"} <= set(got)
    assert got["mamba_us.gen"]["value"] > 0 < got["moe_us.gen"]["value"]
    # no kernel ran on a card: nothing for the rooflines to read
    assert not {"scan_roofline.gen", "kernel_roofline.gen"} & set(got)


def test_the_scan_bytes_by_hand():
    """A prefill of 5 tokens at din 4 and N 16 (no state in) and a
    decode step of 2 sequences (state in): x, dt, z, y at 2 bytes an
    element, the state at 4 each way."""
    counters = {"ssm.scan_tokens": 5 + 2,
                "ssm.scan_channels": 5 * 4 + 2 * 4,
                "ssm.scan_states": 4 * 16 + 2 * 2 * 4 * 16}
    want = 8 * (5 * 4 + 2 * 4) + 4 * (64 + 256)
    assert scan_work.least_bytes(counters) == want
    assert scan_work.least_seconds(counters) == want / 3.35e12
    assert scan_work.least_bytes({}) == 0


def _control_model() -> dict:
    """A bfloat16 Jamba2 of 16 layers of width 256 and 8,192 ids, where
    the cell's limits part the program (logit gap 1.9-2.1, its median
    over positions 1.15-1.17, 6 % of the draws below the reference's
    threshold; seeds 2^31 + 11 and + 12) from the control (5.1-6.5,
    4.1-4.3, 50-53 %) as they do at full size; the smoke scale's float32
    width 64 is too narrow for float8's rounding to show."""
    tiny = _tiny_model()
    return dict(tiny, num_layers=16, d_model=256, d_ff=1024, vocab=8192,
                n_heads=4, n_kv_heads=2, d_head=64,
                moe=dict(tiny["moe"], d_ff_expert=1024),
                param_dtype="bfloat16", compute_dtype="bfloat16")


def test_the_control_fails_where_the_program_passes():
    from clutchbench.control import readings
    over = {"config": {"model": _control_model()}, "mix": TINY_MIX}
    numbers = readings(M, CELL, 2 ** 31 + 11, 1.0, device="cpu",
                       overrides=over)
    assert all(numbers[k]["value"] > numbers[k]["limit"]
               for k in ("logit_gap_median", "dropped_share")), numbers
    res, _ = run.run_cell(M, CELL, 2 ** 31 + 11, 0.5, False, device="cpu",
                          overrides=over)
    assert res["correct"], res["checks"]
