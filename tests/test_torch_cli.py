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


def test_nmc_exposure_flags_emit_xva(capsys, tmp_path):
    from mc_tpu_torch import cli

    npz = tmp_path / "surface.npz"
    assert cli.main([
        "nmc", "--device", "cpu", "--n-paths", "256", "--n-steps", "6",
        "--n-inner", "8", "--payoff", "vanilla_call", "--strategy", "grid",
        "--exposure", "--cva-hazard", "0.02", "--dva-hazard", "0.01",
        "--fva-spread", "0.01", "--collateral-threshold", "1",
        "--mpor-steps", "2", "--im-quantile", "0.99", "--mva-spread", "0.01",
        "--wwr-beta", "0.05", "--wwr-spot-beta", "2",
        "--surface-npz", str(npz)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("expected_exposure", "pfe", "collateralized_ee",
              "initial_margin"):
        assert len(res[k]) == 6, k
    assert res["cva"] > 0 and res["dva"] == 0.0
    assert res["bilateral_cva"] == res["cva"]
    assert res["fca"] > 0 and res["fba"] == 0.0
    assert 0 <= res["collateralized_cva"] <= res["cva"]
    assert res["mva"] > 0 and res["cva_wwr"] > res["cva"]
    assert res["cva_wwr_spot"] > res["cva"]  # a long call: spot WWR raises
    import numpy as np
    assert np.load(npz)["surface"].shape == (256, 6)
    with pytest.raises(SystemExit, match="strategy grid"):
        cli.main(["nmc", "--device", "cpu", "--n-paths", "64", "--n-steps",
                  "4", "--n-inner", "4", "--exposure", "--cva-hazard",
                  "0.02", "--wwr-spot-beta", "1"])


def test_price_importance_shift(capsys):
    from mc_tpu_torch import cli

    assert cli.main(["price", "--device", "cpu", "-K", "180", "--n-paths",
                     "20000", "--n-steps", "8", "--importance-shift",
                     "auto"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(res["price"] - res["black_scholes"]) <= 4 * res["stderr"]
    assert res["stderr"] < 0.1 * res["price"]


def test_cuda_default_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    proc = _run("-m", "mc_tpu_torch", "price", "--n-paths", "1000")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    import mc_tpu_torch as mt
    sim = mt.SimParams(n_paths=64, n_steps=4, n_paths_inner=4)
    for fn in (mt.simulate_trajectories, mt.price_nmc, mt.price_portfolio):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(mt.DEMO_OPTION, sim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.price_ladder([90.0, 110.0], mt.DEMO_OPTION, sim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.price_nmc(mt.DEMO_OPTION, sim, strategy="grid")
    for fn in (mt.greeks, mt.chunked_price):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(mt.DEMO_OPTION, sim)
    with pytest.raises((RuntimeError, AssertionError)):
        mt.coupon_dates(0.5, 0.25, 4)  # a CUDA tensor by default
    proc = _run("-m", "mc_tpu_torch", "greeks", "--n-paths", "1000")
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


def test_ladder_and_book_subcommands_emit_json(capsys):
    from mc_tpu_torch import cli, oracle

    assert cli.main(["ladder", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "8", "--k-min", "80", "--k-max", "120",
                     "--n-strikes", "5", "--antithetic"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["strikes"] == [80.0, 90.0, 100.0, 110.0, 120.0]
    assert res["n_paths"] == 20000
    for k, p, se in zip(res["strikes"], res["prices"], res["stderrs"]):
        assert abs(p - oracle.bs_call(100.0, k, 1.0, 0.1, 0.2)) <= 4 * se
    assert res["prices"] == sorted(res["prices"], reverse=True)

    assert cli.main(["book", "--device", "cpu", "--n-paths", "4096",
                     "--n-steps", "8", "--n-contracts", "6"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["payoff"] == "vanilla_call" and res["n_contracts"] == 6
    assert len(res["prices"]) == 6 and min(res["prices"]) > 0
    assert 0 < res["stderr_max"] < 1


def test_price_closed_form_fields(capsys):
    from mc_tpu_torch import cli, oracle

    base = ["price", "--device", "cpu", "--n-paths", "20000", "--n-steps",
            "8"]
    assert cli.main(base + ["--payoff", "vanilla_put"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # as mc_tpu's cli prints it: the call's closed form for the put too
    assert res["black_scholes"] == oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert "implied_vol" not in res
    assert cli.main(base) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(res["implied_vol"] - 0.2) < 0.01
    assert cli.main(base + ["--payoff", "digital_call"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(res["price"] - res["closed_form"]) <= 4 * res["stderr"]
    assert cli.main(base + ["--payoff", "up_out_call_bb"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(res["price"] - res["closed_form_continuous_barrier"]) <= (
        4 * res["stderr"])


def test_greeks_subcommand_emits_json(capsys):
    """mc_tpu's greeks flags: the default which goes through autograd, a
    kernel-sized which adds the stderrs and the price, lrm its own set."""
    from mc_tpu_torch import cli
    from mc_tpu_torch.greeks import greeks

    base = ["greeks", "--device", "cpu", "--n-paths", "4096", "--n-steps",
            "8"]
    assert cli.main(base) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["delta", "rho", "theta", "vega"]
    assert 0.3 < res["delta"] < 1.0 and res["theta"] < 0
    assert cli.main(base + ["--which", "delta,vega", "--payoff",
                            "asian_call"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    import mc_tpu_torch as mt
    want = greeks(mt.OptionParams(), mt.SimParams(n_paths=4096, n_steps=8),
                  "asian_call", which=("delta", "vega"), device="cpu")
    assert res == {k: float(v) for k, v in want.items()}
    assert cli.main(base + ["--method", "lrm", "--payoff", "bullet_call",
                            "--p1", "1", "--p2", "6"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == sorted(["delta", "vega", "rho", "price"]
                                 + [f"{k}_stderr" for k in
                                    ("delta", "vega", "rho", "price")])
