"""The benchmark's files: every cell, configuration, traffic mix and metric
loads, names and units keep to the allowed characters, BENCHMARK.json
agrees with them, and a cell, configuration, traffic maker, reference or
metric is added by adding files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import torch

torch.set_num_threads(1)

from portbench import harness as H  # noqa: E402

ROOT = os.path.dirname(H.PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names(kind):
    return sorted(f[:-5] for f in os.listdir(os.path.join(H.PKG, kind))
                  if f.endswith(".json"))


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_loads_with_allowed_names():
    cells = _names("workloads")
    assert cells
    for name in cells:
        cell = H.load_cell(name)
        assert NAME.match(name) and NAME.match(cell.workload["config"])
        assert NAME.match(cell.workload["traffic"])
        assert cell.workload["chips"] in (1, 4)
        assert 1 <= len(cell.workload["why"]) <= 200
        assert "\n" not in cell.workload["why"]
        assert set(cell.workload["metrics"]["end_to_end"]) >= {"setup_s"}
        assert H.maker(cell).make
        for metric in cell.workload["metrics"]["per_layer"]:
            assert NAME.match(metric)
            mod = H.reader(metric)
            assert UNIT.match(mod.UNIT) and callable(mod.read)


def test_every_config_and_traffic_file_loads():
    for name in _names("configs"):
        cfg = H.load("configs", name)
        assert NAME.match(name) and cfg["source"].startswith("https://")
        assert all(NAME.match(k) for k in cfg["reduced"])
    for name in _names("traffic"):
        assert NAME.match(name) and H.load("traffic", name)["maker"]


def test_benchmark_json_agrees_with_the_files():
    b = _bench()
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in configs.values():
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert H.load("configs", c["name"])["source"] == c["source"]
        assert c["reduced"] == H.load("configs", c["name"])["reduced"]
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    for w in b["workloads"]:
        cell = H.load_cell(w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell.workload["config"], cell.workload["traffic"],
            cell.workload["chips"], cell.workload["why"])
        assert w["config"] in configs
        assert set(cell.workload["metrics"]["end_to_end"]) == {
            m["name"] for m in b["end_to_end"]
            if w["name"] in m.get("workloads", [w["name"]])}
        assert set(cell.workload["metrics"]["per_layer"]) == {
            name for name, m in per_layer.items()
            if w["name"] in m.get("workloads", [w["name"]])}
        for name in cell.workload["metrics"]["per_layer"]:
            assert H.reader(name).UNIT == per_layer[name]["unit"]


NEW_READER = '''UNIT = "steps"


def read(ctx):
    return ctx.stretch["steps"]
'''
NEW_MAKER = '''from portbench.traffic.faces import *  # noqa: F401,F403
'''
NEW_REFERENCE = '''from portbench.reference.vae import *  # noqa: F401,F403
'''


def test_new_files_are_found_without_editing_any(tmp_path):
    """A copy of the package with a new configuration and its reference,
    traffic mix and its maker, metric and cell, each a new file: the
    harness finds them."""
    copy = tmp_path / "portbench"
    shutil.copytree(H.PKG, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(H.load("configs", "clear-vae64-celeba"), reference="new_ref")
    (copy / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (copy / "reference" / "new_ref.py").write_text(NEW_REFERENCE)
    traffic = dict(H.load("traffic", "celeba-k1"), maker="new_maker",
                   n_train=64)
    (copy / "traffic" / "new-mix.json").write_text(json.dumps(traffic))
    (copy / "traffic" / "new_maker.py").write_text(NEW_MAKER)
    (copy / "metrics" / "new.metric.py").write_text(NEW_READER)
    cell = {"config": "new-config", "traffic": "new-mix", "chips": 1,
            "why": "a test", "trace": {"epochs": 1},
            "metrics": {"end_to_end": ["setup_s"],
                        "per_layer": ["new.metric"]},
            "limits": {}}
    (copy / "workloads" / "new-cell.json").write_text(json.dumps(cell))
    code = ("from portbench import harness as H; import torch; "
            "c = H.load_cell('new-cell'); m = H.maker(c); "
            "d = m.make(c.traffic, 3, 'cpu'); r = H.reference(c); "
            "print(c.config['name'], m.__name__, d['images'].shape[0], "
            "H.reader('new.metric').UNIT, r.__name__, "
            "len(r.param_spec(c.config)), H.PKG)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}:{ROOT}"})
    assert out.stdout.split() == ["clear-vae64-celeba",
                                  "portbench.traffic.new_maker", "64",
                                  "steps", "portbench.reference.new_ref",
                                  "52", str(copy)]
