"""The harness finds its files by name, adds cells from new files alone,
refuses to run without a card, and loads nothing of JAX."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.harness import Bench, run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_every_cell_names_files_that_exist():
    bench = Bench()
    for w in bench.spec["workloads"]:
        assert bench.load("configs", w["config"])["name"] == w["config"]
        traffic = bench.load("traffic", w["traffic"])
        assert os.path.exists(os.path.join(bench.dir, "jobs", traffic["job"] + ".py"))
        assert bench.load("checks", w["name"])
        for m in bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]))
        moves = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in moves and len(moves) >= 2
        assert all(m["moves"] in moves for m in bench.per_layer(w["name"]))
    for c in bench.spec["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"


def test_per_layer_selection_follows_the_lists():
    bench = Bench()
    names = {m["name"] for m in bench.per_layer("glm-epsilon.tron")}
    assert "b2_roofline.glm" in names and "b1_roofline.glmix" not in names
    assert "b3_roofline.glmix" not in {m["name"] for m in bench.per_layer("glmix-ml20m.lbfgs")}


@pytest.fixture
def copy_root(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_new_files_add_a_cell_and_a_metric_without_an_edit(copy_root):
    (copy_root / "portbench" / "traffic" / "lbfgs-1pass.json").write_text(json.dumps(
        {"job": "game_passes", "why": "one pass", "passes": 1, "fe_optimizer": "LBFGS",
         "fe_max_iterations": 50, "re_optimizer": "LBFGS", "re_max_iterations": 30,
         "tolerance": 1e-7, "traced_units": 1}))
    shutil.copy(copy_root / "portbench" / "checks" / "glmix-ml20m.lbfgs.json",
                copy_root / "portbench" / "checks" / "glmix-ml20m.onepass.json")
    (copy_root / "portbench" / "metrics" / "passes_seen.glmix.py").write_text(
        "def read(ctx):\n    return float(ctx['passes']) if ctx.get('config') == 'glmix' else None\n")
    spec = json.loads((copy_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "glmix-ml20m.onepass", "config": "glmix-ml20m",
                              "traffic": "lbfgs-1pass", "chips": 1, "why": "one pass"})
    spec["end_to_end"][0]["workloads"].append("glmix-ml20m.onepass")
    spec["per_layer"].append({"name": "passes_seen.glmix", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "whole step",
                              "moves": "glmix_samples_per_s",
                              "workloads": ["glmix-ml20m.onepass"]})
    (copy_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(copy_root)
    assert "passes_seen.glmix" in {m["name"] for m in bench.per_layer("glmix-ml20m.onepass")}
    assert bench.reader("passes_seen.glmix")({"config": "glmix", "passes": 4}) == 4.0
    result, lines = run_cell(bench, "glmix-ml20m.onepass", 2**31 + 99, 0.0, False, device="cpu",
                             scale=0.001, log=lambda m: None)
    assert result["correct"] and result["attempted"] == 1
    assert set(result["metrics"]) == {"glmix_samples_per_s", "setup_s"}
    assert list(result)[-1] == "checks" and len(lines) == len(result["checks"])


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "glm-epsilon.tron",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_the_command_refuses_to_run_without_the_program(copy_root):
    code = ("import sys; sys.path.insert(0, '.'); from portbench.harness import Bench, run_cell;"
            "run_cell(Bench('.'), 'glmix-ml20m.lbfgs', 1, 0.0, False, device='cpu', scale=0.001)")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy_root, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and "photon_ml_tpu_torch" in out.stderr


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax():
    loaded = _loaded_after(
        "from portbench.harness import Bench, run_cell\n"
        "for cell, scale in (('glmix-ml20m.lbfgs', 0.001), ('glm-epsilon.tron', 0.005)):\n"
        "    run_cell(Bench(), cell, 3, 0.0, False, device='cpu', scale=scale, log=lambda m: None)")
    assert "photon_ml_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_references_load_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.glmix, portbench.reference.glm")
    assert not loaded & ({"photon_ml_tpu_torch"} | set(harness.FORBIDDEN))
