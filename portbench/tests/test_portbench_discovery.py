"""The harness finds a cell, a configuration, a traffic mix and a metric by
name from files alone, and BENCHMARK.json keeps to the benchmark's
contract: a new cell needs new files and entries, and no edit of a file
that is there."""
import dataclasses
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness.serve import run_cell
from portbench.harness.spec import load_cell
from portbench.reference.decoder import shape_of
from portbench.tests.tiny import tiny_arch, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_new_cell_is_found_from_new_files_only(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "portbench"
    conf = json.loads((d / "configs" / "gpt2-xl.json").read_text())
    conf["n_layer"] = 24
    (d / "configs" / "gpt2-half.json").write_text(json.dumps(conf))
    mix = json.loads((d / "traffic" / "doc-prefill-1536.json").read_text())
    mix["prompt"]["mean"] = 1024
    (d / "traffic" / "doc-1k.json").write_text(json.dumps(mix))
    wl = json.loads((d / "workloads" / "gpt2-xl.doc-prefill.json")
                    .read_text())
    (d / "workloads" / "gpt2-half.doc-1k.json").write_text(json.dumps(wl))
    (d / "metrics" / "queued_ms.serve.py").write_text(
        "def read(rec):\n    return rec.get('queued_ms')\n")
    bench["configs"].append({**bench["configs"][1], "name": "gpt2-half",
                             "file": "portbench/configs/gpt2-half.json"})
    bench["workloads"].append({"name": "gpt2-half.doc-1k",
                               "config": "gpt2-half", "traffic": "doc-1k",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "queued_ms.serve", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "paged batcher (serve/paged.py)",
                               "moves": "tok_s",
                               "workloads": ["gpt2-half.doc-1k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(tmp_path, "gpt2-half.doc-1k")
    assert shape_of(cell.config).layers == 24
    assert cell.traffic["prompt"]["mean"] == 1024
    assert cell.workload == wl
    assert [m.name for m in cell.end_to_end] == ["tok_s", "setup_s"]
    names = [m.name for m in cell.per_layer]
    assert names == ["queued_ms.serve"]
    assert cell.per_layer[0].reader({"queued_ms": 2.5}) == 2.5
    # the old cells are unchanged by the addition
    old = load_cell(tmp_path, "gpt2-xl.doc-prefill")
    assert "queued_ms.serve" not in [m.name for m in old.per_layer]
    with pytest.raises(KeyError):
        load_cell(tmp_path, "no-such.cell")


# mixes that the one generator reads from data alone: a replayed list of
# lengths, and an open loop with a Poisson stream of arrivals
NEW_MIXES = {
    "replayed": {"arrivals": "backlog",
                 "replay": [[48, 6], [16, 8], [64, 6], [30, 7]]},
    "open-loop": {"arrivals": "poisson", "rate": 20.0, "block": 8,
                  "pairing_seed": 0,
                  "prompt": {"mean": 40, "sigma": 0.4, "min": 16,
                             "max": 64},
                  "output": {"mean": 10, "sigma": 0.5, "min": 6,
                             "max": 16}},
}
TTFT_READER = """import numpy as np


def read(rec):
    t = rec["ttft_s"]
    return float(np.percentile(t, 95)) * 1e3 if t else None
"""


@pytest.mark.parametrize("mix", sorted(NEW_MIXES))
def test_a_new_mix_and_end_to_end_metric_run_from_new_files(tmp_path, mix):
    """A cell with a mix of another kind, and an open loop's time to first
    token as a new end-to-end metric, added as files and entries only;
    the tiny model stands in for the configuration's sizes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "portbench"
    (d / "traffic" / f"{mix}.json").write_text(json.dumps(NEW_MIXES[mix]))
    name = f"gpt2-xl.{mix}"
    (d / "workloads" / f"{name}.json").write_text(
        json.dumps(tiny_cell("gpt2").workload))
    (d / "metrics" / "ttft_p95_ms.py").write_text(TTFT_READER)
    bench["workloads"].append({"name": name, "config": "gpt2-xl",
                               "traffic": mix, "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "ttft_p95_ms", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(tmp_path, name)
    assert cell.traffic == NEW_MIXES[mix]
    assert [m.name for m in cell.end_to_end] == ["tok_s", "setup_s",
                                                 "ttft_p95_ms"]
    tiny = dataclasses.replace(cell, config=tiny_cell("gpt2").config)
    r = run_cell(tiny, 2 ** 31 + 5, 0.0, False, device="cpu",
                 arch=tiny_arch("gpt2"), cycles=6)
    assert r["correct"], r["checks"]
    values = {m.name: m.reader(r["record"]) for m in cell.end_to_end}
    assert values["tok_s"] > 0 and values["setup_s"] > 0
    assert 0 < values["ttft_p95_ms"] < float("inf")
    # the benchmark's own cells are unchanged by the addition
    old = load_cell(tmp_path, "gpt2-xl.doc-prefill")
    assert [m.name for m in old.end_to_end] == ["tok_s", "setup_s"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_metrics(cell):
    c = load_cell(ROOT, cell)
    assert {m.name for m in c.end_to_end} == {"tok_s", "setup_s"}
    assert len(c.per_layer) == 7
    assert all(callable(m.reader) for m in c.end_to_end + c.per_layer)
    assert c.config["reduced"] == next(
        x["reduced"] for x in BENCH["configs"] if x["name"] == c.config_name)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    cells = {w["name"] for w in BENCH["workloads"]}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            assert set(e.get("workloads", [])) <= cells
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
