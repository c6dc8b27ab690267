"""mc_tpu_torch's command line and import hygiene, on the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
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


def test_heston_subcommand_prints_mc_tpus_keys(capsys):
    from mc_tpu_torch import cli

    assert cli.main(["heston", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "8", "--scheme", "qe"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["cf_oracle", "payoff", "price", "scheme", "stderr"]
    assert res["scheme"] == "qe" and res["payoff"] == "vanilla_call"
    assert abs(res["price"] - res["cf_oracle"]) < 0.5  # as mc_tpu's cli test
    assert cli.main(["heston", "--device", "cpu", "--n-paths", "4096",
                     "--n-steps", "8", "--payoff", "asian_call",
                     "--antithetic"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "cf_oracle" not in res and 0 < res["price"] < 10


def test_nmc_model_heston_emits_xva(capsys):
    from mc_tpu_torch import cli

    assert cli.main(["nmc", "--model", "heston", "--strategy", "grid",
                     "--exposure", "--cva-hazard", "0.02", "--dva-hazard",
                     "0.01", "--wwr-spot-beta", "2", "--payoff",
                     "vanilla_call", "--device", "cpu", "--n-paths", "256",
                     "--n-steps", "6", "--n-inner", "8", "--xi", "0.5"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(res["expected_exposure"]) == 6 and len(res["pfe"]) == 6
    assert res["cva"] > 0 and res["bilateral_cva"] == res["cva"]
    assert res["cva_wwr_spot"] > res["cva"]
    assert res["n_points"] == 256 * 6


def test_heston_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    import mc_tpu_torch as mt
    sim = mt.SimParams(n_paths=64, n_steps=4, n_paths_inner=4)
    for fn in (mt.price_heston, mt.price_nmc_heston):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(mt.DEMO_OPTION, mt.DEMO_HESTON, sim)
    proc = _run("-m", "mc_tpu_torch", "heston", "--n-paths", "1000")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_merton_subcommand_prints_mc_tpus_keys(capsys):
    from mc_tpu_torch import cli

    assert cli.main(["merton", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "8", "--method", "terminal"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["lam", "merton_series_oracle", "payoff", "price",
                           "stderr"]
    assert abs(res["price"] - res["merton_series_oracle"]) <= 4 * res["stderr"]
    assert cli.main(["merton", "--device", "cpu", "--n-paths", "4096",
                     "--n-steps", "8", "--payoff", "asian_call",
                     "--antithetic", "--lam", "1.0"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "merton_series_oracle" not in res and res["lam"] == 1.0
    assert 0 < res["price"] < 10


def test_bates_subcommand_prints_mc_tpus_keys(capsys):
    from mc_tpu_torch import cli

    assert cli.main(["bates", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "8", "--scheme", "qe"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["cf_oracle", "payoff", "price", "scheme", "stderr"]
    assert res["scheme"] == "qe"
    assert abs(res["price"] - res["cf_oracle"]) < 0.5  # as mc_tpu's cli test


@pytest.mark.parametrize("model", ["merton", "bates"])
def test_nmc_model_jump_family_is_its_price_nmc(model, capsys):
    """nmc --model merton|bates builds the family's own dynamics from its
    flags (--lam/--mu-j/--sigma-j, and the Heston flags under bates) and
    prices through price_nmc_<model> on the same inputs, bit for bit."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = ["nmc", "--model", model, "--strategy", "grid", "--exposure",
            "--cva-hazard", "0.02", "--payoff", "vanilla_call", "--device",
            "cpu", "--n-paths", "256", "--n-steps", "6", "--n-inner", "8",
            "--lam", "1.2", "--mu-j", "0.05", "--sigma-j", "0.25", "--xi",
            "0.5"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sim = mt.SimParams(n_paths=256, n_steps=6, n_paths_inner=8)
    if model == "merton":
        want = mt.price_nmc_merton(
            mt.OptionParams(), mt.MertonDynamics(1.2, 0.05, 0.25), sim,
            strategy="grid", device="cpu")
    else:
        want = mt.price_nmc_bates(
            mt.OptionParams(), mt.BatesDynamics(xi=0.5, lam=1.2, mu_j=0.05,
                                                sigma_j=0.25), sim,
            strategy="grid", device="cpu")
    assert res["outer_price"] == float(want.outer.price)
    assert res["surface_mean"] == float(want.surface_mean)
    assert len(res["expected_exposure"]) == 6 and res["cva"] > 0
    # the default flags give the demo dynamics, another surface
    assert cli.main(argv[:-8]) == 0
    other = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert other["outer_price"] != res["outer_price"]


def test_jump_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    import mc_tpu_torch as mt
    sim = mt.SimParams(n_paths=64, n_steps=4, n_paths_inner=4)
    for fn, dyn in ((mt.price_merton, mt.DEMO_MERTON),
                    (mt.price_nmc_merton, mt.DEMO_MERTON),
                    (mt.price_bates, mt.DEMO_BATES),
                    (mt.price_nmc_bates, mt.DEMO_BATES)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(mt.DEMO_OPTION, dyn, sim)


def test_cev_subcommand_prints_mc_tpus_keys(capsys):
    from mc_tpu_torch import cli

    assert cli.main(["cev", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "20", "--antithetic"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["beta", "ncx2_oracle", "payoff", "price", "stderr"]
    assert abs(res["price"] - res["ncx2_oracle"]) <= (
        4 * res["stderr"] + 0.005 * res["ncx2_oracle"])  # test_cev.py's gate
    assert cli.main(["cev", "--device", "cpu", "--n-paths", "4096",
                     "--n-steps", "8", "--beta", "1.0"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "ncx2_oracle" not in res and res["beta"] == 1.0  # GBM: no form


def test_localvol_subcommand_prints_mc_tpus_keys(capsys):
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    assert cli.main(["localvol", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "20", "--beta", "0.7",
                     "--antithetic"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["cev_oracle", "payoff", "price", "stderr",
                           "z_score"]
    assert abs(res["z_score"]) < 4.0
    assert res["cev_oracle"] == pytest.approx(mt.cev_call_closed_form(
        100.0, 100.0, 1.0, 0.1, 0.2 * 100.0 ** 0.3, 0.7), rel=1e-12)
    argv = ["localvol", "--device", "cpu", "--n-paths", "4096", "--n-steps",
            "8", "--smile-curv", "0.3", "--term-slope", "0.1", "--n-knots",
            "5"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["payoff", "price", "stderr"]
    surf = mt.LocalVolSurface.from_function(
        lambda x, t: 0.2 + 0.3 * x * x + 0.1 * t, 8, n_knots=5)
    want = mt.price_localvol(mt.OptionParams(), surf,
                             mt.SimParams(n_paths=4096, n_steps=8),
                             device="cpu")
    assert res["price"] == float(want.price)


@pytest.mark.parametrize("model", ["cev", "localvol"])
def test_nmc_model_cev_localvol_is_its_price_nmc(model, capsys):
    """nmc --model cev builds CEVDynamics.from_atm_vol(--sigma-atm, --beta,
    --s0); --model localvol mc_tpu's nmc surface sigma + curv*x^2 (no term
    slope); each prices through price_nmc_<model>, bit for bit."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = ["nmc", "--model", model, "--strategy", "grid", "--exposure",
            "--cva-hazard", "0.02", "--payoff", "vanilla_call", "--device",
            "cpu", "--n-paths", "256", "--n-steps", "6", "--n-inner", "8",
            "--sigma-atm", "0.3", "--beta", "0.6", "--smile-curv", "0.4"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sim = mt.SimParams(n_paths=256, n_steps=6, n_paths_inner=8)
    if model == "cev":
        want = mt.price_nmc_cev(
            mt.OptionParams(), mt.CEVDynamics.from_atm_vol(0.3, 0.6), sim,
            strategy="grid", device="cpu")
    else:
        surf = mt.LocalVolSurface.from_function(
            lambda x, t: 0.2 + 0.4 * x * x, 6)
        want = mt.price_nmc_localvol(mt.OptionParams(), surf, sim,
                                     strategy="grid", device="cpu")
    assert res["outer_price"] == float(want.outer.price)
    assert res["surface_mean"] == float(want.surface_mean)
    assert len(res["expected_exposure"]) == 6 and res["cva"] > 0
    assert cli.main(argv[:-6]) == 0  # the default flags: another surface
    other = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert other["surface_mean"] != res["surface_mean"]


def test_cev_localvol_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    import mc_tpu_torch as mt
    sim = mt.SimParams(n_paths=64, n_steps=4, n_paths_inner=4)
    surf = mt.LocalVolSurface.demo(4)
    for fn, dyn in ((mt.price_cev, mt.DEMO_CEV),
                    (mt.price_nmc_cev, mt.DEMO_CEV),
                    (mt.price_localvol, surf),
                    (mt.price_nmc_localvol, surf)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(mt.DEMO_OPTION, dyn, sim)


def test_sabr_subcommand_prints_mc_tpus_keys(capsys):
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    assert cli.main(["sabr", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "20", "--antithetic"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["hagan_implied_vol", "hagan_oracle",
                           "mc_implied_vol", "payoff", "price", "stderr"]
    # tests/test_sabr.py's gate: MC noise + the expansion's ~1%
    assert abs(res["price"] - res["hagan_oracle"]) <= (
        4 * res["stderr"] + 0.01 * res["hagan_oracle"])
    assert res["mc_implied_vol"] == pytest.approx(res["hagan_implied_vol"],
                                                  abs=0.01)
    argv = ["sabr", "--device", "cpu", "--n-paths", "4096", "--n-steps", "8",
            "--payoff", "asian_call", "--alpha", "0.3", "--beta", "0.7",
            "--nu", "0.6", "--rho-fv", "0.2"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["payoff", "price", "stderr"]
    want = mt.price_sabr(mt.OptionParams(), mt.SABRDynamics(0.3, 0.7, 0.6,
                                                            0.2),
                         mt.SimParams(n_paths=4096, n_steps=8), "asian_call",
                         device="cpu")
    assert res["price"] == float(want.price)


def test_term_subcommand_prints_mc_tpus_keys(capsys):
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    assert cli.main(["term", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "20", "--antithetic"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["oracle", "payoff", "price", "rate_knots",
                           "sigma_knots", "stderr", "z_score"]
    assert abs(res["z_score"]) < 3.5  # exact in law
    assert res["rate_knots"] == [0.1, 0.07, 0.05]
    argv = ["term", "--device", "cpu", "--n-paths", "4096", "--n-steps", "8",
            "--payoff", "asian_call", "--rate-knots", "0.02,0.08",
            "--sigma-knots", "0.4,0.1"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "oracle" not in res
    want = mt.price_term(mt.OptionParams(), mt.TermStructure.from_knots(
        [0.02, 0.08], [0.4, 0.1], 8), mt.SimParams(n_paths=4096, n_steps=8),
        "asian_call", device="cpu")
    assert res["price"] == float(want.price)


def test_divs_subcommand_prints_mc_tpus_keys(capsys):
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    assert cli.main(["divs", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "50"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["dividends", "payoff", "price",
                           "quadrature_oracle", "stderr", "z_score"]
    assert res["dividends"] == [[24, 5.0]] and abs(res["z_score"]) < 3.5
    argv = ["divs", "--device", "cpu", "--n-paths", "4096", "--n-steps", "8",
            "--div-steps", "1,5", "--div-amounts", "2.5,4"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "quadrature_oracle" not in res  # two payments: no oracle
    want = mt.price_divs(mt.OptionParams(), mt.div_schedule(8, [1, 5],
                                                            [2.5, 4.0]),
                         mt.SimParams(n_paths=4096, n_steps=8), device="cpu")
    assert res["price"] == float(want.price)
    with pytest.raises(SystemExit, match="pair up"):
        cli.main(["divs", "--device", "cpu", "--div-steps", "1,2",
                  "--div-amounts", "3"])


@pytest.mark.parametrize("model", ["sabr", "term"])
def test_nmc_model_sabr_term_is_its_price_nmc(model, capsys):
    """nmc --model sabr builds SABRDynamics(--alpha, --nu, rho=--rho-sv),
    as mc_tpu's; --model term prices mc_tpu's default curves; each through
    price_nmc_<model>, bit for bit."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = ["nmc", "--model", model, "--strategy", "grid", "--exposure",
            "--cva-hazard", "0.02", "--payoff", "vanilla_call", "--device",
            "cpu", "--n-paths", "256", "--n-steps", "6", "--n-inner", "8",
            "--alpha", "0.3", "--nu", "0.6", "--rho-sv", "-0.2"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sim = mt.SimParams(n_paths=256, n_steps=6, n_paths_inner=8)
    if model == "sabr":
        want = mt.price_nmc_sabr(mt.OptionParams(),
                                 mt.SABRDynamics(alpha=0.3, nu=0.6, rho=-0.2),
                                 sim, strategy="grid", device="cpu")
    else:
        want = mt.price_nmc_term(sim=sim, strategy="grid", device="cpu")
    assert res["outer_price"] == float(want.outer.price)
    assert res["surface_mean"] == float(want.surface_mean)
    assert len(res["expected_exposure"]) == 6 and res["cva"] > 0


def test_sabr_term_divs_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    import mc_tpu_torch as mt
    sim = mt.SimParams(n_paths=64, n_steps=4, n_paths_inner=4)
    term = mt.TermStructure.from_knots([0.1], [0.2], 4)
    for fn, dyn in ((mt.price_sabr, mt.DEMO_SABR),
                    (mt.price_nmc_sabr, mt.DEMO_SABR),
                    (mt.price_term, term), (mt.price_nmc_term, term),
                    (mt.price_divs, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(mt.DEMO_OPTION, dyn, sim)


def test_vasicek_subcommand_prints_mc_tpus_keys(capsys):
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    assert cli.main(["vasicek", "--device", "cpu", "--n-paths", "20000",
                     "--n-steps", "8", "--antithetic"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["oracle", "payoff", "price", "stderr", "z_score"]
    # exact in law: tests/test_vasicek.py's 3.5 stderr
    assert res["oracle"] == mt.bsv_call(100.0, 100.0, 1.0, 0.1, 0.2, 0.3,
                                        0.05, 0.015, -0.3)
    assert abs(res["z_score"]) <= 3.5
    argv = ["vasicek", "--device", "cpu", "--n-paths", "4096", "--n-steps",
            "4", "--payoff", "zcb", "--a", "1.0", "--b", "0.03",
            "--sigma-r", "0.05", "--rho-r", "0.2"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["oracle"] == mt.vasicek_zcb(0.1, 1.0, 0.03, 0.05, 1.0)
    want = mt.price_vasicek(mt.OptionParams(),
                            mt.VasicekDynamics(1.0, 0.03, 0.05, 0.2),
                            mt.SimParams(n_paths=4096, n_steps=4), "zcb",
                            device="cpu")
    assert res["price"] == float(want.price)
    assert res["stderr"] == float(want.stderr)
    argv[argv.index("zcb")] = "asian_call"
    assert cli.main(argv) == 0
    assert "oracle" not in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])


def test_basket_subcommand_prints_mc_tpus_keys(capsys):
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = ["basket", "--device", "cpu", "--n-paths", "4096", "--n-steps",
            "8", "--n-assets", "3", "--corr", "0.2", "--payoff", "asian_call",
            "--antithetic"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(res) == ["n_assets", "payoff", "price", "stderr"]
    want = mt.price_basket(mt.OptionParams(), mt.demo_basket(3, 0.2),
                           mt.SimParams(n_paths=4096, n_steps=8),
                           "asian_call", antithetic=True, device="cpu")
    assert res["n_assets"] == 3 and res["price"] == float(want.price)
    assert res["stderr"] == float(want.stderr)


@pytest.mark.parametrize("model", ["vasicek", "basket"])
def test_nmc_model_vasicek_basket_is_its_price_nmc(model, capsys):
    """nmc --model vasicek builds VasicekDynamics(--a, --b, --sigma-r,
    rho=--rho-r) and --model basket the demo basket of --n-assets at
    --corr, as mc_tpu's; each through price_nmc_<model>, bit for bit."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = ["nmc", "--model", model, "--strategy", "grid", "--exposure",
            "--cva-hazard", "0.02", "--payoff", "vanilla_call", "--device",
            "cpu", "--n-paths", "256", "--n-steps", "6", "--n-inner", "8",
            "--a", "0.5", "--b", "0.04", "--sigma-r", "0.02", "--rho-r",
            "0.1", "--n-assets", "3", "--corr", "0.3"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sim = mt.SimParams(n_paths=256, n_steps=6, n_paths_inner=8)
    if model == "vasicek":
        want = mt.price_nmc_vasicek(mt.OptionParams(),
                                    mt.VasicekDynamics(0.5, 0.04, 0.02, 0.1),
                                    sim, strategy="grid", device="cpu")
    else:
        want = mt.price_nmc_basket(mt.OptionParams(), mt.demo_basket(3, 0.3),
                                   sim, strategy="grid", device="cpu")
    assert res["outer_price"] == float(want.outer.price)
    assert res["surface_mean"] == float(want.surface_mean)
    assert len(res["expected_exposure"]) == 6 and res["cva"] > 0


def test_vasicek_basket_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    import mc_tpu_torch as mt
    sim = mt.SimParams(n_paths=64, n_steps=4, n_paths_inner=4)
    for fn, dyn in ((mt.price_vasicek, mt.DEMO_VASICEK),
                    (mt.price_nmc_vasicek, mt.DEMO_VASICEK),
                    (mt.price_basket, mt.DEMO_BASKET),
                    (mt.price_nmc_basket, mt.DEMO_BASKET)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(mt.DEMO_OPTION, dyn, sim)


def _mc_tpu_cli(argv, capsys):
    """The last JSON line mc_tpu's CLI prints for ``argv`` (engine="xla")."""
    from mc_tpu import cli as jcli

    capsys.readouterr()
    assert jcli.main(argv + ["--engine", "xla"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("contract", ["quanto_call", "compo_put", "gk_call"])
def test_fx_subcommand_matches_mc_tpus(contract, capsys):
    """fx: mc_tpu's keys; the oracle equal, the price within the parity
    contract of mc_tpu's on the same stream, and price_fx's bit for bit."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = ["fx", "--n-paths", "4099", "--contract", contract, "--x0",
            "1.2", "--rho-fx", "0.3", "--kx", "1.1"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_cli(argv, capsys)
    assert sorted(res) == sorted(want) == ["contract", "oracle", "price",
                                           "stderr", "z"]
    assert res["oracle"] == want["oracle"]
    assert res["price"] == pytest.approx(want["price"], rel=1e-5)
    own = mt.price_fx(mt.OptionParams(), mt.FXDynamics(x0=1.2, rho=0.3,
                                                       kx=1.1),
                      mt.SimParams(n_paths=4099), contract, device="cpu")
    assert res["price"] == float(own.price)


@pytest.mark.parametrize("n_assets,payoff", [(2, "call_on_max"),
                                             (2, "exchange"),
                                             (5, "put_on_min")])
def test_rainbow_subcommand_matches_mc_tpus(n_assets, payoff, capsys):
    """rainbow: spots and vols interpolated from (--s0, --sigma) to
    (--s02, --sigma2); at d = 2 the Stulz or Margrabe column and its
    z-score; --greeks adds mc_tpu's delta, vega and cega_01 (its
    rainbow_greeks within 1e-5 of the largest entry)."""
    from mc_tpu_torch import cli

    argv = ["rainbow", "--n-paths", "3001", "--n-assets", str(n_assets),
            "--corr", "0.3", "--payoff", payoff, "--antithetic"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_cli(argv, capsys)
    assert sorted(res) == sorted(want)
    assert res["price"] == pytest.approx(want["price"], rel=1e-5)
    if n_assets == 2:
        assert res["oracle"] == pytest.approx(want["oracle"], abs=1e-4)
        assert abs(res["z_score"]) < 4.0
    assert cli.main(argv + ["--device", "cpu", "--greeks"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_cli(argv + ["--greeks"], capsys)
    assert sorted(res) == sorted(want)
    scale = max(abs(x) for x in want["vega"])
    for key in ("delta", "vega"):
        assert len(res[key]) == n_assets
        np.testing.assert_allclose(res[key], want[key], rtol=0,
                                   atol=1e-5 * scale)
    assert res["cega_01"] == pytest.approx(want["cega_01"], rel=0,
                                           abs=1e-5 * scale)


@pytest.mark.parametrize("family,payoff", [("lattice", "vanilla_call"),
                                           ("sobol", "asian_call")])
def test_qmc_subcommand_matches_mc_tpus(family, payoff, capsys):
    """qmc --model gbm: mc_tpu's keys and fields; --model heston prices
    (against mc_tpu: tests/test_torch_qmc_model_cases.py)."""
    from mc_tpu_torch import cli

    argv = ["qmc", "--n-paths", "2000", "--n-steps", "6", "--n-shifts", "4",
            "--family", family, "--payoff", payoff]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_cli(argv, capsys)
    assert sorted(res) == sorted(want)
    assert res["lattice_n"] == want["lattice_n"] and res["n_shifts"] == 4
    assert res["price"] == pytest.approx(want["price"], rel=1e-5)
    if payoff == "vanilla_call":
        assert res["black_scholes"] == pytest.approx(want["black_scholes"],
                                                     rel=1e-6)
    assert cli.main(["qmc", "--model", "heston", "--n-paths", "1024",
                     "--n-steps", "4", "--n-shifts", "2", "--device",
                     "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["model"] == "heston" and res["point_n"] == 1021
    assert res["stderr"] > 0 and res["cf_oracle"] > 0


def test_nmc_model_rainbow_is_its_price_nmc(capsys):
    """nmc --model rainbow: the demo basket of --n-assets at --corr, as
    mc_tpu's, through price_nmc_rainbow bit for bit; --discount is fixed."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = ["nmc", "--model", "rainbow", "--strategy", "grid", "--exposure",
            "--cva-hazard", "0.02", "--payoff", "call_on_max", "--device",
            "cpu", "--n-paths", "256", "--n-steps", "6", "--n-inner", "8",
            "--n-assets", "3", "--corr", "0.3"]
    assert cli.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = mt.price_nmc_rainbow(mt.OptionParams(), mt.demo_basket(3, 0.3),
                                mt.SimParams(n_paths=256, n_steps=6,
                                             n_paths_inner=8),
                                strategy="grid", device="cpu")
    assert res["outer_price"] == float(want.outer.price)
    assert res["surface_mean"] == float(want.surface_mean)
    assert len(res["expected_exposure"]) == 6 and res["cva"] > 0
    with pytest.raises(SystemExit, match="discount"):
        cli.main(argv + ["--discount", "remaining"])


def test_rainbow_fx_qmc_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    import mc_tpu_torch as mt
    sim = mt.SimParams(n_paths=64, n_steps=4, n_paths_inner=4)
    for call in (lambda: mt.price_rainbow(sim=sim),
                 lambda: mt.price_nmc_rainbow(sim=sim),
                 lambda: mt.price_fx(sim=sim),
                 lambda: mt.price_qmc(sim=sim)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _mc_tpu_rates_cli(argv, capsys):
    """The last JSON line mc_tpu's CLI prints for ``argv``: on its fused
    route (engine="xla") where the subcommand has one, single-curve
    hullwhite and g2pp; else on its classic route (swaption, multi-curve).
    The classic route adds its payoffs in one f32 sum, 2e-6 off its own
    fused route's Kahan slabs under Hull-White at 6 payments (ROADMAP
    C23)."""
    from mc_tpu import cli as jcli

    if argv[0] != "swaption" and "--proj-spread-bp" not in argv:
        argv = argv + ["--engine", "xla"]
    capsys.readouterr()
    assert jcli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


RATES_ARGV = {
    "swaption": ["swaption", "--n-paths", "4099", "--k-rate", "0.06"],
    "hullwhite": ["hullwhite", "--n-paths", "4099", "--n-payments", "6"],
    "hullwhite_mc": ["hullwhite", "--n-paths", "4099", "--proj-spread-bp",
                     "25"],
    "hullwhite_par": ["hullwhite", "--n-paths", "4099", "--par-swap-rates",
                      "0.03,0.034,0.039,0.042,0.045,0.047"],
    "g2pp": ["g2pp", "--n-paths", "4099", "--rho-xy", "-0.3"],
}


@pytest.mark.parametrize("receiver", [False, True],
                         ids=["payer", "receiver"])
@pytest.mark.parametrize("case", sorted(RATES_ARGV))
def test_rates_subcommands_match_mc_tpus(case, receiver, capsys):
    """swaption, hullwhite (single-curve, --proj-spread-bp, a bootstrapped
    curve) and g2pp: mc_tpu's keys, its oracle and curve discounts equal,
    the price within tests/test_torch_rates.py's PRICE_RTOL of mc_tpu's,
    and the library call's bit for bit."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import cli

    argv = RATES_ARGV[case] + (["--receiver"] if receiver else [])
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_rates_cli(argv, capsys)
    assert sorted(res) == sorted(want)
    assert res["oracle"] == want["oracle"]
    assert res["price"] == pytest.approx(want["price"], rel=5e-7, abs=1e-9)
    assert res.get("curve_dfs") == want.get("curve_dfs")
    spec = mt.SwaptionSpec(k_rate=0.06 if case == "swaption" else 0.04,
                           n_payments=6 if case == "hullwhite" else 10,
                           payer=not receiver)
    sim = mt.SimParams(n_paths=4099)
    if case == "swaption":
        own = mt.price_swaption(spec, sim=sim, r0=0.1, device="cpu")
    elif case == "g2pp":
        own = mt.price_g2_swaption(spec, mt.G2Dynamics(rho=-0.3), sim=sim,
                                   device="cpu")
    else:
        curve = (mt.DiscountCurve.from_par_swaps(
            [0.5, 1, 2, 3, 5, 10], [0.03, 0.034, 0.039, 0.042, 0.045, 0.047])
            if case == "hullwhite_par" else mt.DEMO_CURVE)
        proj = (mt.DiscountCurve(curve.times, curve.zeros + 0.0025)
                if case == "hullwhite_mc" else None)
        own = mt.price_hw_swaption(spec, curve=curve, sim=sim,
                                   projection_curve=proj, device="cpu")
    assert res["price"] == float(own.price)


@pytest.mark.parametrize("command,flags", [
    ("swaption", ["--bermudan"]), ("swaption", ["--bounds"]),
    ("swaption", ["--qmc"]), ("swaption", ["--greeks"]),
    ("swaption", ["--exposure"]), ("swaption", ["--cva-hazard", "0.02"]),
    ("hullwhite", ["--bermudan"]), ("hullwhite", ["--bounds"]),
    ("hullwhite", ["--qmc"]), ("hullwhite", ["--greeks"]),
    ("hullwhite", ["--exposure"]), ("hullwhite", ["--cva-hazard", "0.02"]),
    ("hullwhite", ["--book-k-rates", "0.03,0.05"]),
    ("hullwhite", ["--book-sides", "p,r"]),
    ("hullwhite", ["--book-weights", "1,-1"]),
    ("hullwhite", ["--bucket-dv01"]), ("hullwhite", ["--curve-var"]),
    ("g2pp", ["--bermudan"]), ("g2pp", ["--bounds"]), ("g2pp", ["--qmc"]),
    ("g2pp", ["--greeks"]), ("g2pp", ["--exposure"]),
    ("g2pp", ["--cva-hazard", "0.02"]), ("g2pp", ["--bucket-dv01"])])
def test_rates_legs_not_ported_exit_naming_their_item(command, flags):
    from mc_tpu_torch import cli

    item = "item 19" if flags == ["--curve-var"] else "item 18"
    with pytest.raises(SystemExit, match=f"{flags[0]} .*ROADMAP {item}"):
        cli.main([command, *flags, "--device", "cpu", "--n-paths", "64"])


def test_rates_subcommands_take_no_tpu_flags(capsys):
    from mc_tpu_torch import cli

    for command in ("swaption", "hullwhite", "g2pp"):
        for flag in (["--engine", "xla"], ["--tile-rows", "128"]):
            with pytest.raises(SystemExit):
                cli.main([command, *flag, "--device", "cpu"])
    capsys.readouterr()


def test_info_subcommand_describes_the_device(capsys):
    """info: mc_tpu's device summary, on the port's device."""
    from mc_tpu_torch import cli

    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "torch" in out and "device: cpu" in out


@pytest.mark.parametrize("model,which", [("gbm", "delta,vega"),
                                         ("heston", "delta,v0,dyn.rho"),
                                         ("merton", "delta,lam")])
def test_nmc_cva_greeks_match_mc_tpus(model, which, capsys):
    """nmc --cva-greeks: mc_tpu's cva_greeks key, each greek within 1e-5
    relative of mc_tpu's CLI (tests/test_torch_cva_greeks.py's bound),
    the family's dynamics from its flags."""
    from mc_tpu_torch import cli

    argv = ["nmc", "--model", model, "--n-paths", "256", "--n-steps", "8",
            "--n-inner", "8", "--payoff", "vanilla_call", "--cva-hazard",
            "0.02", "--cva-greeks", which, "--v0", "0.05", "--lam", "0.4"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_cli(argv, capsys)
    assert sorted(res["cva_greeks"]) == sorted(want["cva_greeks"])
    for k, v in want["cva_greeks"].items():
        assert res["cva_greeks"][k] == pytest.approx(v, rel=1e-5), k
    with pytest.raises(SystemExit, match="needs --cva-hazard"):
        cli.main(["nmc", "--device", "cpu", "--n-paths", "64", "--n-steps",
                  "4", "--n-inner", "4", "--cva-greeks", "delta"])


@pytest.mark.parametrize("model", ["gbm", "heston"])
def test_nmc_book_strikes_match_mc_tpus(model, capsys):
    """nmc --book-strikes/--book-weights: mc_tpu's keys; the per-contract
    prices and netted profiles within the port's book tolerance of mc_tpu's
    (tests/test_torch_nmc_book.py); --cva-greeks refused with a book."""
    from mc_tpu_torch import cli

    argv = ["nmc", "--model", model, "--n-paths", "512", "--n-steps", "8",
            "--n-inner", "8", "--payoff", "vanilla_call", "--book-strikes",
            "90,100,110", "--book-weights", "1,-0.5,2", "--cva-hazard",
            "0.02"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_cli(argv, capsys)
    assert sorted(res) == sorted(want)
    assert res["n_contracts"] == 3
    scale = max(want["netted_pfe"])
    for key in ("per_contract_price", "netted_ee", "netted_pfe",
                "sum_of_standalone_ee"):
        np.testing.assert_allclose(res[key], want[key], rtol=0,
                                   atol=1e-5 * scale + 2e-6)
    assert res["netted_cva"] == pytest.approx(want["netted_cva"], rel=1e-5)
    with pytest.raises(SystemExit, match="not supported with --book"):
        cli.main(argv + ["--device", "cpu", "--cva-greeks", "delta"])
