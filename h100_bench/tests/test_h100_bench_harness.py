"""The harness on the CPU: BENCHMARK.json against the contract's rules,
everything found by name, the result line's keys, and a cell added as
files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_tiny import DEIT, RESNET, TINY_TRAFFIC, tiny_config, tiny_run
from h100_bench import run as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return R.load_json(R.BENCHMARK)


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("h100_bench/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # each cell: setup_s, one more end-to-end, a layer
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_every_file_is_found_by_name(bench):
    for w in bench["workloads"]:
        traffic = R.load_json(R.HERE / "traffic" / f"{w['traffic']}.json")
        R.load_module("drivers", traffic["mode"])
        for kind in ("programs", "reference", "work"):
            R.load_module(kind, w["config"])
        assert (R.HERE / "configs" / f"{w['config']}.json").is_file()
    for m in bench["per_layer"]:
        assert callable(R.load_module("metrics", m["name"]).read)
    with pytest.raises(FileNotFoundError):
        R.load_module("metrics", "no_such_metric")


@pytest.mark.parametrize("workload", [DEIT, RESNET])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(bench, workload, trace):
    run = tiny_run(workload, trace=trace, dtype="float32")
    result = R.execute(run)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in run.metrics_of(kind)}
    assert set(result["metrics"]) <= allowed
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # what a CPU trace can read: the host's time and the counted FLOPs
        assert {"host_issue_ms.serve", "mfu.serve"} <= set(result["metrics"])
    else:
        assert set(result["metrics"]) == allowed
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(result)


def test_a_cell_added_as_files_is_picked_up(tmp_path, bench):
    """A new traffic mix, a new per-layer metric and a new cell: files and
    BENCHMARK.json entries alone, no file of the harness edited."""
    root = tmp_path / "h100_bench"
    shutil.copytree(R.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "serve_bs8_two_pools.json").write_text(json.dumps(
        dict(TINY_TRAFFIC, batch=2, pool=3)))
    (root / "metrics" / "issue_count.serve.py").write_text(
        "def read(run):\n    return float(len(run.window['issue']))\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "laud_deit_s_token.serve_bs8_two_pools",
                             "config": "laud_deit_s_token",
                             "traffic": "serve_bs8_two_pools", "chips": 1,
                             "why": "a test cell"})
    for m in new["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("laud_deit_s_token.serve_bs8_two_pools")
    new["per_layer"].append({
        "name": "issue_count.serve", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "infer.engine",
        "moves": "serve_img_per_s",
        "workloads": ["laud_deit_s_token.serve_bs8_two_pools"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = "laud_deit_s_token.serve_bs8_two_pools"
    run = R.make_run(cell, seed=5, seconds=0.3, trace=True, device="cpu",
                     root=root, config=tiny_config("laud_deit_s_token"))
    result = R.execute(run)
    assert run.traffic["pool"] == 3 and result["correct"]
    assert result["metrics"]["issue_count.serve"]["value"] > 0


def test_forbidden_modules_compares_whole_names():
    assert R.forbidden_modules(["laudnet_tpu_torch", "laudnet_tpu_torch.ops",
                                "jaxtyping", "flaxen"]) == []
    assert R.forbidden_modules(["laudnet_tpu.models", "jax._src",
                                "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "laudnet_tpu"]


def test_no_card_no_result(capsys, monkeypatch):
    """Without a card the run exits with code 2 and prints no result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = R.main(["--workload", DEIT, "--seed", "1", "--seconds", "1"])
    assert code == 2
    assert capsys.readouterr().out == ""
