"""The ``lm`` kind: its configuration is the published one but for the
departures it lists, its reference lays the weights out as the port
does and computes what the port computes, the check replays the sample
through the engine, and a configuration of kind ``lm`` is found and
run through files added alone."""

import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from clutchbench import run, work
from clutchbench.manifest import Manifest

HOME = Path(__file__).resolve().parents[1]
ROOT = HOME.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "minitron-8b.gen-1024x128"
M = Manifest(ROOT / "BENCHMARK.json")
KIND = M.kind("lm")
REF = M.reference("lm_dense")


def _tiny_model():
    """The configuration's model at the port's smoke scale (float32)."""
    full = KIND.model_config(M.config("minitron-8b")["model"])
    return json.loads(json.dumps(dataclasses.asdict(full.reduced())))


TINY_MIX = {"slots": 4, "max_len": 40, "prompt_len": 24, "new_tokens": 8,
            "pool_per_s": 20, "check_sample": 4}


#: the configuration's ``model`` keys and the published config's
PUBLISHED = {"num_layers": "num_hidden_layers", "d_model": "hidden_size",
             "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads", "d_head": "head_dim",
             "d_ff": "intermediate_size", "mlp": "hidden_act",
             "vocab": "vocab_size", "norm_eps": "norm_eps",
             "rope_theta": "rope_theta",
             "tie_embeddings": "tie_word_embeddings"}


def test_the_configuration_is_the_published_one_but_its_departures():
    """Every width and setting the port's model expresses is the
    published one; what it cannot express is listed in ``reduced``,
    each with its reason, here and in ``BENCHMARK.json``."""
    cfg = M.config("minitron-8b")
    pub, model = cfg["published"], cfg["model"]
    for mine, theirs in PUBLISHED.items():
        assert model[mine] == pub[theirs], mine
    assert sorted(cfg["departures"]) == sorted(cfg["reduced"])
    assert all(key in pub for key in cfg["reduced"])
    entry = next(c for c in BENCH["configs"] if c["name"] == "minitron-8b")
    assert entry["reduced"] == cfg["reduced"]
    assert set(PUBLISHED.values()) | set(cfg["reduced"]) | {"source"} \
        == set(pub)


def test_every_model_key_is_passed_through():
    """Lists become tuples and an object the dataclass its field holds,
    so a configuration with experts needs no edit of the kind."""
    from repro_torch.configs.base import MoEConfig
    model = {**_tiny_model(), "moe": {"num_experts": 4, "top_k": 2,
                                      "d_ff_expert": 64, "moe_layers": [0]},
             "rope_theta": 500.0}
    cfg = KIND.model_config(model)
    assert cfg.moe == MoEConfig(4, 2, 64, (0,))
    assert cfg.block_pattern == ("attn",) and cfg.rope_theta == 500.0


def test_the_reference_lays_the_weights_out_as_the_port():
    """Names, shapes and dtypes of the reference's layout equal the
    port's ``init_params`` tree (on the meta device: shapes only), at
    full width."""
    from repro_torch.models import lm
    model = M.config("minitron-8b")["model"]
    cfg = KIND.model_config(model)
    port = KIND._flat(lm.init_params(cfg, torch.Generator(), "meta"))
    ref = REF.layout(model)
    assert list(port) == list(ref)
    for name, (shape, _) in ref.items():
        assert tuple(port[name].shape) == shape, name
        assert port[name].dtype == getattr(torch, model["param_dtype"])
    n = sum(t.numel() for t in port.values())
    assert 8.27e9 < n < 8.28e9


def test_the_reference_is_the_port_forward_on_seeded_weights():
    """float32 at the smoke scale: the port's full forward, and the
    engine's logits in the replay (three requests fed their tokens, a
    fourth filling the last slot), within 1e-4 of the reference."""
    model = _tiny_model()
    cell = run.Cell(M, CELL, 2 ** 31 + 7, "cpu",
                    {"config": {"model": model}, "mix": TINY_MIX})
    flat = KIND.make_weights(cell)
    from repro_torch.models import lm
    toks = torch.randint(0, model["vocab"], (4, 32),
                         generator=torch.Generator().manual_seed(5))
    full = lm.forward_logits(KIND.model_config(model), KIND.nested(flat),
                             {"tokens": toks})[..., :model["vocab"]]
    reqs = [(toks[j, :24].numpy(), toks[j, 24:].tolist()) for j in range(3)]
    replay = KIND._replay(cell, flat, reqs, [toks[3, :24].numpy()])
    assert replay.shape == (3, 8, model["vocab"])
    for j in range(3):
        want = REF.logits(flat, model, toks[j], start=0)
        assert (full[j] - want).abs().max() < 1e-4
        assert (replay[j] - want[23:31]).abs().max() < 1e-4


def test_the_replay_fills_every_slot():
    """The replay's engine holds as many requests as the mix has slots:
    the sample, then the pool's other prompts of its lengths."""
    cell = run.Cell(M, CELL, 3, "cpu",
                    {"config": {"model": _tiny_model()}, "mix": TINY_MIX})
    plain = [(torch.full((24,), i).numpy(), 8) for i in range(6)]
    plain.append((torch.zeros(20, dtype=torch.int64).numpy(), 8))
    fill = KIND._fillers(cell, plain, [(1, None), (4, None)], 24, 8, 2)
    assert [int(p[0]) for p in fill] == [0, 2]
    fill = KIND._fillers(cell, plain, [(0, None)], 24, 8, 1)
    assert [int(p[0]) for p in fill] == [1, 2, 3]


def test_fp8_control_rounds_every_matrix():
    t = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    r = KIND.fp8(t)
    assert r.dtype == torch.float32 and not torch.equal(r, t)
    assert (r - t).abs().max() <= t.abs().max() / 448 * 32
    v = torch.ones(8)
    assert torch.equal(KIND.fp8(v), v)


def test_the_tiny_run_agrees_with_the_reference():
    res, found = run.run_cell(M, CELL, 2 ** 31 + 9, 0.4, False, device="cpu",
                              overrides={"config": {"model": _tiny_model()},
                                         "mix": TINY_MIX})
    assert res["correct"], res["checks"]
    assert found["logit_gap"] < 1e-4 and found["token_gap"] < 1e-4
    assert found["tokens"] == 4 * 8 and res["failed"] == 0
    assert res["attempted"] >= 4


def test_decoder_work_by_hand():
    """One layer, d 4, 2 heads and 1 KV head of 2, MLP 8, vocab 16;
    float32 weights, a cache of 2 slots of 10 positions."""
    weights = [("embed.tok", (16, 4), 4), ("embed.head", (4, 16), 4),
               ("final_norm.scale", (4,), 4),
               ("w.q", (1, 4, 4), 4), ("w.kv", (1, 4, 2), 4),
               ("w.mlp", (1, 4, 8), 4)]
    cache = [("k", (1, 2, 10, 2), 2), ("v", (1, 2, 10, 2), 2)]
    c = work.DecoderWork(weights, ("embed.tok",), ("embed.head",), cache,
                         2, 10, n_heads=2, d_head=2)
    assert c.weight_bytes == (64 + 4 + 16 + 8 + 32) * 4
    assert c.row_bytes == 16 and c.logit_row_bytes == 64
    assert c.flops_token == 2 * (16 + 8 + 32) and c.flops_last == 2 * 64
    assert c.pos_bytes == 2 * 2 * 2 and c.flops_pair == 2 * (2 * 2 * 2)
    # a decode step of 2 slots attending 3 + 5 positions
    want_b = c.weight_bytes + 2 * 16 + 8 * 8 + 2 * 64
    want_f = (112 + 128) * 2 + 16 * 8
    assert c.decode(2, 8) == pytest.approx(max(
        want_b / work.PEAK_BYTES_S, want_f / work.PEAK_BF16_FLOPS_S))
    # a prefill of 4 tokens: 10 (query, key) pairs, the head once
    want_b = c.weight_bytes + 4 * 16 + 4 * 8 + 64
    want_f = 112 * 4 + 128 + 16 * 10
    assert c.prefill(4) == pytest.approx(max(
        want_b / work.PEAK_BYTES_S, want_f / work.PEAK_BF16_FLOPS_S))


def test_an_lm_configuration_is_added_by_files_alone(tmp_path):
    """A copy of the harness, to which only files are added: a
    configuration of kind ``lm`` naming a reference module of its own (a
    copy of the dense one), a mix, and a cell in a copied
    ``BENCHMARK.json``; ``run_cell`` finds and runs it."""
    home = tmp_path / "clutchbench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(home / "reference" / "lm_dense.py",
                home / "reference" / "lm_other.py")
    cfg = {"name": "other-lm", "kind": "lm", "reference": "lm_other",
           "model": {**_tiny_model(), "name": "other-lm", "d_ff": 96},
           "sampler": {"min_p": 0.05, "temperature": 1.0},
           "limits": {"wrong_requests": 0, "logit_gap": 1e-4,
                      "token_gap": 1e-4}}
    (home / "configs" / "other-lm.json").write_text(json.dumps(cfg))
    (home / "mixes" / "gen-tiny.json").write_text(json.dumps(
        {"generator": "prompts", **TINY_MIX, "new_tokens": 5,
         "warmup": 1, "warmup_new_tokens": 2, "check_sample": 3}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "other-lm", "source": "x", "file": "x",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "other-lm.gen-tiny",
                               "config": "other-lm", "traffic": "gen-tiny",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("other-lm.gen-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    m = Manifest(tmp_path / "BENCHMARK.json", home=home)
    res, found = run.run_cell(m, "other-lm.gen-tiny", 5, 0.3, False,
                              device="cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"gen_tokens_per_s", "setup_s"}
    assert found["tokens"] == 3 * 5
    res, _ = run.run_cell(m, "other-lm.gen-tiny", 5, 0.3, True,
                          device="cpu")
    assert res["correct"]
    assert "launches_per_step.gen" in res["metrics"]
