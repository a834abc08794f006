"""The Moonlight cell on the CPU: the manifest's new cell and its files,
the benchmark's reference copy of the tower against the tests'
(tests/ref_moonlight.py) at a tiny size, the cost file against a hand
count, and a tiny run of the cell through the benchmark's own driver and
run (sound, with the same routes as the reference; a planted fault
caught; the counters read in a traced run)."""

import copy
import importlib.util
import json
import os

import pytest
import torch

from perfbench.common import faults
from perfbench.costs import flops, moe as moe_cost
from perfbench.reference import moonlight as ref_ml

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")
CELLS = {"dta-davis-moonlight-b32": ("dta-fragnet-moonlight",
                                     "dta_davis_moonlight_b32",
                                     "task_train_moonlight")}
TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            experts_held=4)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _tests_reference():
    spec = importlib.util.spec_from_file_location(
        "tests_ref_moonlight", os.path.join(ROOT, "tests", "ref_moonlight.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_new_cells_name_files_that_exist():
    man = _json(ROOT, "BENCHMARK.json")
    cells = {c["name"]: c for c in man["workloads"]}
    confs = {c["name"]: c for c in man["configs"]}
    for name, (config, traffic, driver) in CELLS.items():
        cell = cells[name]
        assert (cell["config"], cell["traffic"], cell["chips"]) == \
            (config, traffic, 1)
        assert os.path.exists(os.path.join(ROOT, confs[config]["file"]))
        tr = _json(BENCH, "traffic", f"{traffic}.json")
        assert tr["driver"] == driver
        assert os.path.exists(os.path.join(BENCH, "drivers", f"{driver}.py"))
    for m in man["per_layer"]:
        if m["name"].endswith(".dta_moe"):
            stem = m["name"].split(".")[0]
            assert os.path.exists(os.path.join(BENCH, "metrics",
                                               f"{stem}.py")), m["name"]


def test_configuration_keeps_the_published_widths():
    cfg = _json(BENCH, "configs", "dta-fragnet-moonlight.json")
    published = dict(hidden_size=2048, intermediate_size=11264,
                     kv_lora_rank=512, moe_intermediate_size=1408,
                     n_routed_experts=64, n_shared_experts=2,
                     num_attention_heads=16, num_experts_per_tok=6,
                     qk_nope_head_dim=128, qk_rope_head_dim=64,
                     v_head_dim=128, rope_theta=50000,
                     routed_scaling_factor=2.446, rms_norm_eps=1e-5,
                     first_k_dense_replace=1, q_lora_rank=None)
    assert {k: cfg[k] for k in published} == published
    assert (cfg["num_hidden_layers"], cfg["experts_held"],
            cfg["vocab_size"]) == (5, 8, 26)
    man = _json(ROOT, "BENCHMARK.json")
    conf = {c["name"]: c for c in man["configs"]}["dta-fragnet-moonlight"]
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"])


def test_reference_copy_equals_the_tests_reference():
    from fragnet_tpu_torch.model.moonlight import (BIAS_UPDATE_SPEED,
                                                   MoonlightConfig,
                                                   MoonlightTower, moe_layers)

    tests_ref = _tests_reference()
    c = {**TINY, "rope_theta": 50000.0, "rms_norm_eps": 1e-5,
         "routed_scaling_factor": 2.446, "first_k_dense_replace": 1,
         "bias_update_speed": BIAS_UPDATE_SPEED}

    tower = MoonlightTower(MoonlightConfig.from_dict(c),
                           torch.Generator().manual_seed(4))
    for layer in moe_layers(tower).values():
        layer.gate.e_score_correction_bias.uniform_(-0.01, 0.01)
    sd = {f"target_model.{k}": v for k, v in tower.state_dict().items()}
    biases = {k: v for k, v in sd.items() if k.endswith("_bias")}
    tokens = torch.randint(1, 26, (3, 24), generator=torch.Generator()
                           .manual_seed(5))
    tokens[0, 15:] = 0
    tokens[2, 4:] = 0
    a, ca = ref_ml.tower(sd, biases, tokens, c)
    b, cb = tests_ref.tower(sd, biases, tokens, c, range(4))
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb)) and len(ca) == 2
    ba = ref_ml.balance(biases, ca, tokens, c)
    bb = tests_ref.balance(biases, cb, tokens, c)
    assert ba.keys() == bb.keys() and all(torch.equal(ba[k], bb[k])
                                          for k in ba)
    with torch.no_grad():
        prog = tower(tokens)
    assert float((prog - a).abs().max()) <= 1e-5 * float(a.abs().max())


def test_costs_match_a_hand_count():
    c = dict(hidden_size=8, num_attention_heads=2, qk_nope_head_dim=3,
             qk_rope_head_dim=2, v_head_dim=4, kv_lora_rank=5,
             num_hidden_layers=3, first_k_dense_replace=1,
             intermediate_size=7, moe_intermediate_size=6,
             n_routed_experts=4, n_shared_experts=2)
    lengths = [3, 1]
    # per residue: q 8·2·5 + kv_a 8·7 + kv_b 5·2·7 + o 2·4·8 = 80 + 56 + 70
    # + 64 = 270 multiply-adds; 4 residues, 3 layers
    proj = 2 * 4 * 270 * 3
    # causal pairs 6 + 1 = 7, each 2 heads · (5 + 4)
    attn = 2 * 7 * 2 * 9 * 3
    dense = 2 * 4 * 3 * 8 * 7
    moe = 2 * (2 * 4 * 8 * 4 + 2 * 4 * 3 * 8 * 12)
    routed = 10 * 2 * 3 * 8 * 6
    assert moe_cost.tower_forward(lengths, 10, c) == \
        proj + attn + dense + moe + routed
    # bytes: T 5 rows of D 8, K 2, A 3 held, U 2 tokens
    row = 32
    by = (4 * 3 + 2 * row + 3 * row) + (40 + 12 + 3 * row + 5 * row) \
        + (40 + 3 * row + 5 * row) + (40 + 12 + 2 * row + 6 * row + 40)
    assert moe_cost.route_bytes(5, 3, 2, 8, 2) == by
    assert moe_cost.route_bound_ms(5, 3, 2, 8, 2) == pytest.approx(
        1e3 * by / 3.35e12)
    counts = {"graphs": 2, "atom": 5, "bond": 8, "frag": 2, "fc": 2,
              "e_atom": 8, "e_bond": 12, "e_frag": 2, "e_fc": 2}
    cfg = {**c, "model": {"emb_dim": 4, "num_layer": 1, "num_heads": 2},
           "head": {"fc1": 3}}
    assert moe_cost.dta_forward(counts, lengths, 10, cfg) == pytest.approx(
        flops.encoder_forward(counts, 1, 4, 2) + 2 * 5 * 4 + 2 * 2 * 4
        + moe_cost.tower_forward(lengths, 10, c)
        + 2 * 2 * ((2 * 4 + 8) * 3 + 3))


# ---------------------------------------------------------------------------
# a tiny run of the Moonlight cell
# ---------------------------------------------------------------------------

def _parts():
    from perfbench import run

    man = copy.deepcopy(run.manifest())
    big = {c["name"]: c for c in man["workloads"]}["dta-davis-moonlight-b32"]
    cfg = _json(BENCH, "configs", "dta-fragnet-moonlight.json")
    tr = _json(BENCH, "traffic", "dta_davis_moonlight_b32.json")
    cfg.update(TINY)
    cfg["model"]["num_layer"] = 2
    cfg["protein"]["max_len"] = 64
    tr.update(drugs={"n": 6, "profile": "lipo", "seed": 11}, batch_size=4,
              train_batches=4, trace_steps=2, reference_micro_batch=3)
    tr["proteins"].update(n=5, median=40, min=10, max=90)
    # a tiny model on the CPU reads other gaps than the cell on the card
    tr["limits"] = {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-2,
                    "route_diff": 0}
    cell = dict(big, name="tiny-dta-moe")
    man["workloads"].append(cell)
    for m in man["end_to_end"] + man["per_layer"]:
        if big["name"] in m.get("workloads", []):
            m["workloads"].append(cell["name"])
    return man, cell, cfg, tr


def _run(seed, traced=False):
    from perfbench import run

    man, cell, cfg, tr = _parts()
    return run.run_cell(cell["name"], seed, 0.5, traced,
                        device=torch.device("cpu"), workers=1, man=man,
                        parts=(cell, cfg, tr))


def test_tiny_moonlight_run_is_correct_with_the_same_routes():
    res, checks = _run(2 ** 40 + 23)
    assert res["correct"], checks
    assert dict((k, v) for k, v, _ in checks)["route_diff"] == 0
    assert res["failed"] == 0 and res["attempted"] > 0


def test_tiny_moonlight_traced_run_reads_the_counters():
    res, checks = _run(9, traced=True)
    assert res["correct"], checks
    ratio = res["metrics"]["expert_load_ratio.dta_moe"]["value"]
    assert ratio >= 1.0


def test_tiny_moonlight_fault_is_caught():
    with faults.FAULTS["half_batch"]():
        res, checks = _run(3)
    assert not res["correct"], checks
