"""mc_tpu_torch's command line and import hygiene, on the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--n-paths", "20000", "--n-steps", "16",
         "--n-inner", "16", "--p1", "1", "--p2", "6"]


def _run(*args, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_demo_runs_and_vanilla_rows_agree_with_black_scholes():
    proc = _run("-m", "mc_tpu_torch", "demo", *SMALL,
                "--nmc-max-paths", "256")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    devs = [float(x) for x in re.findall(r"\(([\d.]+) se from BS\)", out)]
    assert len(devs) == 5, out
    assert max(devs) <= 3.5, out
    for label in ("bullet antithetic", "outer estimate",
                  "surface mean over all points"):
        assert label in out


def test_price_and_nmc_subcommands_emit_json():
    proc = _run("-m", "mc_tpu_torch", "price", *SMALL, "--antithetic")
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert abs(res["price"] - res["black_scholes"]) <= 4 * res["stderr"]
    assert res["n_paths"] == 20000
    proc = _run("-m", "mc_tpu_torch", "nmc", "--device", "cpu", "--n-paths",
                "128", "--n-steps", "6", "--n-inner", "8", "--p1", "1",
                "--p2", "5")
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n_points"] == 128 * 6
    assert res["outer_stderr"] > 0


def test_cuda_default_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    proc = _run("-m", "mc_tpu_torch", "price", "--n-paths", "1000")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_import_keeps_jax_nvcc_and_triton_out():
    code = ("import sys, mc_tpu_torch\n"
            "from mc_tpu_torch.ops import _cuda\n"
            "bad = [m for m in ('jax', 'mc_tpu', 'triton', "
            "'torch.utils.cpp_extension') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "assert _cuda._lib is None\n")
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stderr


def test_sources_never_import_jax_or_mc_tpu():
    pat = re.compile(r"^\s*(import jax|from jax|import mc_tpu\b"
                     r"|from mc_tpu[ .])", re.M)
    for path in (ROOT / "mc_tpu_torch").rglob("*.py"):
        assert not pat.search(path.read_text()), path
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run("chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
