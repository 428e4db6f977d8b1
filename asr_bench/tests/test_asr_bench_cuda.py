"""On a card: one short run of the first cell through the command the
driver runs, correct and with its end-to-end metrics. Skips where there
is no CUDA card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from asr_bench import core


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(core.ROOT, "asr_bench", "run.py"),
         "--workload", "flagship.decode_enh", "--seed", str(2**31 + 3),
         "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert {"decode_utt_per_s", "setup_s"} <= set(result["metrics"])
