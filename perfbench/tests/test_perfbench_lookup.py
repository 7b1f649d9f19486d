"""Every name in ``BENCHMARK.json`` finds its file, an unknown name fails
loudly, and the file keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.reference.diinn import param_spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        harness.load_driver(cell.traffic["kind"])
        assert param_spec(cell.config)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
        assert set(cell.limits) >= {"loss_gap", "grad_norm_gap",
                                    "change_norm_gap", "pred_gap"} or \
            set(cell.limits) >= {"max_abs_gap"}
        assert cell.controls


@pytest.mark.parametrize("kind,name", [("configs", "no-such-config"),
                                       ("traffic", "no-such-mix"),
                                       ("limits", "no.such-cell")])
def test_unknown_files_fail_loudly(kind, name):
    with pytest.raises(harness.NotFound, match=name):
        harness.load_named(kind, name)


def test_unknown_metric_workload_and_driver_fail_loudly(bench):
    with pytest.raises(harness.NotFound, match="no_such_metric"):
        harness.load_reader("no_such_metric")
    with pytest.raises(harness.NotFound, match="no-such-cell"):
        harness.load_cell(bench, "no-such-cell")
    with pytest.raises(harness.NotFound, match="nothing"):
        harness.load_driver("nothing")


def test_a_per_layer_metric_without_workloads_fails_loudly(bench):
    b = json.loads(json.dumps(bench))
    del b["per_layer"][0]["workloads"]
    with pytest.raises(harness.NotFound, match=b["per_layer"][0]["name"]):
        harness.load_cell(b, b["workloads"][0]["name"])


def test_a_new_cell_takes_only_data(bench, tmp_path, monkeypatch):
    """A cell over an existing driver: a traffic file, a limits file and
    an entry; the harness finds them by name."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    t = json.loads((harness.BENCH / "traffic" / "train-b16-x234.json")
                   .read_text())
    t.update(scales=[2, 2.5])
    (tmp_path / "traffic" / "train-x2.5.json").write_text(json.dumps(t))
    (tmp_path / "limits" / "diinn-rdn.train-x2.5.json").write_text(
        json.dumps({"controls": ["fp8"],
                    "limits": {"loss_gap": {"limit": 1}}}))
    for sub in ("configs", "metrics", "drivers"):
        (tmp_path / sub).symlink_to(harness.BENCH / sub)
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "diinn-rdn.train-x2.5",
                           "config": "diinn-rdn", "traffic": "train-x2.5",
                           "chips": 1, "why": "x2.5"})
    b["end_to_end"][0]["workloads"].append("diinn-rdn.train-x2.5")
    cell = harness.load_cell(b, "diinn-rdn.train-x2.5")
    assert cell.traffic["scales"] == [2, 2.5]
    assert "train_pixels_per_s" in {m["name"] for m in cell.end_to_end}


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(_one_line(w) for w in bench["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _one_line(c["source"])
        assert _one_line(c["why"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        names.add(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _one_line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert set(m["workloads"]) <= cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    all_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(all_names) == len(set(all_names))
