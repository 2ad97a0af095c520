"""The harness: cells, configurations, traffic and metrics found by name
from the files alone; a run on the CPU at a small size agrees with the
reference and prints only the contract's keys; the no-JAX check."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import ROOT, small_cell, workload_names
from portbench import guard, harness, spec

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checks"]


def cpu_run(name, seconds=0.5, seed=2**31 + 77):
    import torch
    from portbench import drive
    return harness.run_cell(drive.program(), torch, small_cell(name), seed,
                            seconds, False, torch.device("cpu"),
                            time.time_ns())


def test_every_name_resolves_to_its_files():
    bench = spec.benchmark()
    assert bench["paths"] == ["portbench"]
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c.config["name"] == w["config"]
        fam = spec.family(c.traffic["family"])
        assert fam.__file__ == os.path.join(
            ROOT, "portbench", "families", c.traffic["family"] + ".py")
        assert fam.RUNNER and fam.CONTROL
        e2e = [m["name"] for m in c.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_every_traffic_file_names_a_family_file():
    for f in os.listdir(os.path.join(ROOT, "portbench", "traffic")):
        with open(os.path.join(ROOT, "portbench", "traffic", f)) as fh:
            fam = json.load(fh)["family"]
        assert os.path.exists(os.path.join(ROOT, "portbench", "families",
                                           fam + ".py")), f


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    bench = spec.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        for w in m.get("workloads", cells):
            names = [x["name"] for x in spec.cell(w).end_to_end]
            assert m["moves"] in names, (m["name"], w)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")


@pytest.mark.parametrize("name", workload_names())
def test_cpu_run_is_correct_with_the_contract_keys(name):
    res = cpu_run(name)
    assert res["correct"], res["checks"]
    assert list(res) == CONTRACT_KEYS
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    json.dumps(res)


def test_guard_compares_whole_top_level_names():
    mods = ["automerge_tpu_torch", "automerge_tpu_torch.engine", "numpy",
            "jaxtyping", "flax_like", "automerge_tpu_tools"]
    assert guard.forbidden_loaded(mods) == []
    bad = mods + ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                  "automerge_tpu", "automerge_tpu.engine"]
    assert guard.forbidden_loaded(bad) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "automerge_tpu", "automerge_tpu.engine"])


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness, drive, control; drive.program(); "
            "from portbench import guard; print(guard.forbidden_loaded())"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_nonzero_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "text_1m.ring_backlog", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_roofline_holds_each_call_to_the_memory_it_fits_in():
    from portbench import roofline as R
    small, big = (5000, 256), (6, 4 * 2 ** 20)
    assert 2 * 5000 * 256 * 4 <= R.L2_BYTES < 2 * 6 * 4 * 2 ** 20 * 4
    assert R.multi_scan_bound_s(small) == 2 * 5000 * 256 * 4 / \
        R.L2_BYTES_PER_S
    assert R.multi_scan_bound_s(big) == 2 * 6 * 4 * 2 ** 20 * 4 / \
        R.HBM_BYTES_PER_S
    assert R.L2_BYTES_PER_S > R.HBM_BYTES_PER_S
