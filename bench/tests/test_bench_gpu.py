"""Card-only: each cell run once, short, through ``bench/run.py`` as the
benchmark's check runs it; skips where there is no CUDA card (decided
inside the test).  On the card: ``python -m pytest -q -m gpu bench/tests``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", name,
                        "--seed", str(2**31 + 99), "--seconds", "2",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
