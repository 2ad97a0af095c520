"""On the card: each cell through run.py as the benchmark runs it, with a
short window, once untraced and once traced. Needs a CUDA card (the
`cuda` marker; it skips without one):

    python3 -m pytest portbench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, workload_names
from portbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", workload_names())
def test_cell_runs_correct_on_the_card(cuda_torch, name, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 101), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    cell = spec.cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for k, v in res["metrics"].items():
            if "roofline" in k:
                assert 0 < v["value"] <= 100
