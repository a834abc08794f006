"""BENCHMARK.json against the contract's form: names, units and lines;
every cell's files; every metric's reader and the cells it is read in."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(man):
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sec in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k], (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in man["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4)
    for c in man["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    metric_names = [n for m, n in names if m]
    assert len(set(metric_names)) == len(metric_names)


def test_cells_have_their_files(man):
    confs = {c["name"]: c for c in man["configs"]}
    used = set()
    for c in man["workloads"]:
        used.add(c["config"])
        assert os.path.exists(os.path.join(ROOT, confs[c["config"]]["file"]))
        with open(os.path.join(BENCH, "traffic", f"{c['traffic']}.json")) as f:
            tr = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           f"{tr['driver']}.py"))
        assert tr["limits"]
    assert used == set(confs)
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)


def test_metric_readers_and_cells(man):
    from perfbench import run

    cells = {c["name"] for c in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(run.reader(m["name"]))
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(run.reader(m["name"]))
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), \
                (m["name"], cell)
    for cell in cells:
        reported = [m for m in man["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in reported)
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in man["per_layer"])
