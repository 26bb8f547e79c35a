"""BENCHMARK.json and the files it names: every cell, configuration and
metric loads and names what it needs, and a new cell is found from files
alone."""
import json
import re
import shutil

import pytest

from bench import check, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|_rank$|d_model|d_ff|top_k)")


def check_benchmark_json(bench):
    """``bench`` (a BENCHMARK.json) keeps the contract's keys and limits."""
    cells = [w["name"] for w in bench["workloads"]]
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"] and bench["command"] == ["python3", "bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"tokens_per_s", "mfu", "peak_mem_gib", "setup_s"} == e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert UNIT.match(m["unit"]) and 1 <= len(m["layer"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs)) and len(cells) == len(set(cells))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_benchmark_json_holds_the_contract_keys():
    check_benchmark_json(BENCH)


def check_cell_files(cell, root=spec.ROOT):
    """The cell ``cell`` of ``root``'s files loads, its limits lie between
    their readings, and its configuration's model module lays it out and
    counts its FLOPs."""
    c = spec.load_cell(cell, root)
    cfg = spec.model_config(c.config)
    assert cfg.num_layers == c.config["model"]["num_layers"]
    for key in ("schedule", "p", "micro_batch", "microbatches", "seq_len", "attn_impl",
                "remat", "warmup_steps", "distinct_batches"):
        assert key in c.traffic, key
    body = json.loads((root / "bench" / "workloads" / f"{cell}.json").read_text())
    skipped = body.get("not_compared", {})
    assert set(c.limits) | set(skipped) == set(check.NUMBERS) and c.limits
    assert not set(c.limits) & set(skipped)
    for k, v in body["limits"].items():  # each limit between the readings it was set from
        assert v["lower"] < v["limit"] < v["upper"], (k, v)
    for k, v in skipped.items():  # a number not compared says why, with its readings
        assert v["why"] and v["lower"] > 0, (k, v)
    assert c.module.leaf_names(cfg)
    assert c.module.flops_per_token(c.config["model"], c.traffic["seq_len"]) > 0
    assert {m["name"] for m in c.end_to_end} == {"tokens_per_s", "mfu", "peak_mem_gib",
                                                  "setup_s"}
    assert c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    check_cell_files(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(spec.metric_reader(metric))


def check_config_file(config, root=spec.ROOT):
    """The configuration entry ``config`` of ``root``'s BENCHMARK.json: its
    file states its cut, and its model module exists and keeps the
    contract."""
    assert config["file"].startswith("bench/configs/")
    body = json.loads((root / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert set(config["reduced"]) == set(body["reduced"])
    assert all(k in body["model"] for k in config["reduced"])
    assert not any(WIDTH.search(k) for k in config["reduced"])
    assert body["assumed"] and body["deployment"]
    # its model module (the default where it names none) exists and keeps the contract
    rel = body.get("model_module", spec.DEFAULT_MODULE)
    assert rel.startswith("bench/models/") and (root / rel).is_file()
    mod = spec.model_module(body, root)
    assert all(callable(getattr(mod, f, None)) for f in spec.MODEL_FUNCTIONS)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(config):
    check_config_file(config)


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    """A cell, a traffic mix, a configuration and a metric added as files
    in a copy of the checkout load with no change to the code."""
    shutil.copytree(spec.BENCH, tmp_path / "bench")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="granite-2l",
                                 file="bench/configs/granite-2l.json"))
    body = json.loads((spec.ROOT / bench["configs"][0]["file"]).read_text())
    body["name"], body["model"]["num_layers"] = "granite-2l", 2
    (tmp_path / "bench/configs/granite-2l.json").write_text(json.dumps(body))
    traffic = json.loads((spec.BENCH / "traffic" / "bpipe.p4.b4.m8.s2048.flash.json").read_text())
    (tmp_path / "bench/traffic/gpipe.p2.b1.m4.s1024.flash.json").write_text(
        json.dumps(dict(traffic, schedule="gpipe", p=2, microbatches=4, seq_len=1024)))
    (tmp_path / "bench/workloads/new.cell.json").write_text(json.dumps(
        {"limits": {k: {"limit": 0.5, "lower": 0.1, "upper": 1.0} for k in check.NUMBERS}}))
    (tmp_path / "bench/metrics/new_metric.py").write_text("def read(ctx):\n    return 1.0\n")
    bench["workloads"].append({"name": "new.cell", "config": "granite-2l",
                               "traffic": "gpipe.p2.b1.m4.s1024.flash", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "tokens_per_s", "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("new.cell", tmp_path)
    assert cell.traffic["schedule"] == "gpipe" and cell.config["model"]["num_layers"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "new_metric"
    assert spec.metric_reader("new_metric", tmp_path)(None) == 1.0
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", tmp_path)
