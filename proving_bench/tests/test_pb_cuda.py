"""The benchmark's command on a card, and its refusal without one."""

import json
import subprocess
import sys

import pytest
import torch

from pb_support import REPO


def _run(*args, timeout=900):
    return subprocess.run([sys.executable, "proving_bench/run.py", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = _run("--workload", "v1-fib-2e16", "--seed", "5", "--seconds", "1", "--trace", "0", timeout=120)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _run("--workload", "v1-fib-2e16", "--seed", str(2**33 + 7), "--seconds", "3", "--trace", trace)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu" and list(result)[-1] == "compared"
