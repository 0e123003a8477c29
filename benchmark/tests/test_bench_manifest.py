"""BENCHMARK.json against the files that carry it: every cell, configuration,
traffic kind and per-layer metric is found by its name, the names and
texts keep to their forms, and every cell reports the set-up time, another
end-to-end metric and a per-layer one."""

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH)]

from harness import cell as cells  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert (ROOT / MAN["command"][1]).is_file() and MAN["command"][1].startswith("benchmark/")
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_texts_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_each_cell_is_found_by_its_name(name):
    entry = next(w for w in MAN["workloads"] if w["name"] == name)
    spec = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    assert spec["config"] == entry["config"] and spec["chips"] == entry["chips"]
    assert spec["why"] == entry["why"]
    assert (BENCH / "traffic" / f"{spec['kind']}.py").is_file()
    c = cells.load(name, ROOT)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and all(m["moves"] in e2e for m in c.per_layer)
    assert c.limits
    assert {m["name"] for m in c.per_layer} >= {m["name"] for m in MAN["per_layer"]
                                                 if name in m.get("workloads", ())}
