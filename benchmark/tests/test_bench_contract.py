"""BENCHMARK.json against the rules the harness relies on: every name,
unit and file that a cell, configuration or metric needs is there and well
formed; and a run on a machine without a card prints no result."""
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open("BENCHMARK.json") as f:
        return json.load(f)


def test_names_units_and_files(bench):
    assert bench["paths"] == ["benchmark"]
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/") and os.path.exists(c["file"])
        with open(c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert os.path.exists(f"benchmark/traffic/{w['traffic']}.json")
        assert w["config"] in {c["name"] for c in bench["configs"]} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        mine = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in bench["per_layer"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(cells.reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:  # each cell it lists reports what it moves
            assert w in next(e for e in bench["end_to_end"] if e["name"] == m["moves"]).get(
                "workloads", [w])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "serve-int8-fleet28",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.parametrize("name, path", [
    ("serve.mfu", "serve.mfu.py"), ("serve.mfu.tail", "serve.mfu.py"),
    ("decode_roofline.serve", "decode_roofline.py"), ("setup_s", "setup_s.py")])
def test_a_metric_name_finds_its_quantity_reader(name, path):
    read = cells.reader(name)
    assert read.__code__.co_filename.endswith("benchmark/metrics/" + path)


def test_a_metric_without_a_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        cells.reader("no_such.metric")
