"""The port's table workers and CLIs against the JAX package's, on the CPU.

* ``run_tuning_worker``, ``rerun_best``, ``filter_done`` and
  ``make_tuning_grid --extend`` against their JAX counterparts on the same
  tables with a stub ``evaluate`` (the cases of ``tests/test_experiment.py::
  TestTuningWorker`` and ``tests/test_sweep_resume.py``): the tables the port
  writes read back through ``pd.read_csv(..., index_col=0)`` equal to the
  JAX package's, and each package's workers continue the other's tables.
* The CLIs (``python -m fiude_tpu_torch.scripts.<name> --device cpu``) in a
  subprocess that blocks ``jax``, ``pandas`` and ``filelock``: ``run_sweep``
  in both modes, ``run_transfer`` from the sweep's CONN weights,
  ``tune_worker --max-rows 1`` and ``tune_encoders`` over a 3-row grid (one
  row an encoder family).  Each prints its
  ``processed`` line, and a second run skips what the ledger (or the
  tuning table) claimed.  A tiny region preset and a short synthetic series
  keep them to seconds.  Without a card and without ``--device cpu`` each
  raises before it touches a file.
* ``tune_encoders --make-grid`` writes the JAX script's file byte for byte,
  and a training step of each encoder family as ``tune_encoders.setup``
  builds it equals the step of the model the JAX script builds, on tied
  weights and eps (rel 2e-4, as ``tests/test_torch_port_train.py``).
"""
import json
import os
import runpy
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import torch

from fiude_tpu.train.experiment import (
    rerun_best as jax_rerun_best, run_tuning_worker as jax_tuning_worker,
)
from fiude_tpu.utils.config import grid as jax_grid
from scripts.run_sweep import filter_done as jax_filter_done

from fiude_tpu_torch.scripts import (
    make_tuning_grid, rerun_best_tuning, run_sweep, run_transfer, tune_encoders, tune_worker,
)
from fiude_tpu_torch.scripts.run_sweep import filter_done
from fiude_tpu_torch.train.experiment import rerun_best, run_tuning_worker
from fiude_tpu_torch.utils.config import grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_ROWS = [dict(latent_dim=4, hidden_size=8, window_size=7, batch_size=4, n_samples=4,
                  epochs=e, started=0, score=10.0) for e in (1, 2)]


def both(tmp_path, frame):
    """The same table written twice by pandas: (port's copy, JAX's copy)."""
    paths = [str(tmp_path / f"{who}.csv") for who in ("port", "jax")]
    for p in paths:
        frame.to_csv(p)
    return paths


def frames_equal(a, b):
    pd.testing.assert_frame_equal(pd.read_csv(a, index_col=0), pd.read_csv(b, index_col=0))


def boom_on_two(params):
    if params["a"] == 2:
        raise RuntimeError("boom")
    return params["a"] * 0.5


@pytest.mark.parametrize("case", ["queue", "provenance", "crash", "more_rows_than_open"])
def test_tuning_worker_matches_jax(tmp_path, case):
    frame, kw = {
        "queue": (pd.DataFrame([{"a": 1, "started": 0, "score": 10.0},
                                {"a": 2, "started": 0, "score": 10.0},
                                {"a": 3, "started": 1, "score": 10.0}]),
                  dict(evaluate=boom_on_two)),
        "provenance": (pd.DataFrame(GRID_ROWS),
                       dict(evaluate=lambda p: float(p["epochs"]), max_rows=10,
                            extra_cols={"platform": "cpu"})),
        "crash": (pd.DataFrame(GRID_ROWS[:1]),
                  dict(evaluate=lambda p: 1 / 0, max_rows=10, extra_cols={"platform": "cpu"})),
        "more_rows_than_open": (pd.DataFrame(GRID_ROWS),
                                dict(evaluate=lambda p: -float(p["epochs"]), max_rows=1)),
    }[case]
    port, jax_csv = both(tmp_path, frame)
    seen = {"port": [], "jax": []}

    def spy(who, fn):
        def evaluate(params):
            seen[who].append({k: (None if isinstance(v, float) and np.isnan(v) else v)
                              for k, v in params.items()})
            return fn(params)
        return evaluate

    n_port = run_tuning_worker(port, **{**kw, "evaluate": spy("port", kw["evaluate"])})
    n_jax = jax_tuning_worker(jax_csv, **{**kw, "evaluate": spy("jax", kw["evaluate"])})
    assert n_port == n_jax
    assert seen["port"] == seen["jax"]
    frames_equal(port, jax_csv)
    if case == "queue":
        df = pd.read_csv(port, index_col=0)
        assert n_port == 2 and df["score"].tolist() == [0.5, 10.0, 10.0]
        assert (df["started"] == 1).all()


def test_workers_of_both_packages_share_one_table(tmp_path):
    csv = str(tmp_path / "vs.csv")
    pd.DataFrame(GRID_ROWS + [dict(GRID_ROWS[0], epochs=3)]).to_csv(csv)
    assert run_tuning_worker(csv, lambda p: float(p["epochs"]), max_rows=1,
                             extra_cols={"platform": "cuda"}) == 1
    assert jax_tuning_worker(csv, lambda p: float(p["epochs"]), max_rows=1,
                             extra_cols={"platform": "cpu"}) == 1
    assert run_tuning_worker(csv, lambda p: float(p["epochs"]), max_rows=5) == 1
    df = pd.read_csv(csv, index_col=0)
    assert df["score"].tolist() == [1.0, 2.0, 3.0]
    assert df["platform"].tolist()[:2] == ["cuda", "cpu"] and np.isnan(df["platform"][2])


def test_rerun_best_matches_jax(tmp_path):
    frame = pd.DataFrame([dict(GRID_ROWS[0], epochs=e, started=1, score=s)
                          for e, s in ((1, 0.5), (2, -1.0), (3, 0.5), (4, float("nan")),
                                       (5, -3.0), (6, 0.25))])
    port, jax_csv = both(tmp_path, frame)

    def evaluate(params, rep):
        truth = np.arange(6.0).reshape(2, 3) * params["epochs"]
        return {"score": params["score"] + rep, "tmax": int(params["epochs"]) + rep,
                "truth": truth, "pred_mean": truth + 0.5, "label": f"e{int(params['epochs'])}"}

    out_port = rerun_best(port, evaluate, run_best=5, run_each=2, out_dir=str(tmp_path / "p"))
    out_jax = jax_rerun_best(jax_csv, evaluate, run_best=5, run_each=2,
                             out_dir=str(tmp_path / "j"))
    frames_equal(out_port, out_jax)
    assert pd.read_csv(out_port, index_col=0)["config_index"].tolist() == [
        4, 4, 1, 1, 5, 5, 0, 0, 2, 2]
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names and len(names) == 11
    for name in names:
        if name.endswith(".json"):
            with open(tmp_path / "p" / name) as a, open(tmp_path / "j" / name) as b:
                assert json.load(a) == json.load(b), name


def resume_configs(**over):
    kw = dict(region=["US"], epochs=[60], window_size=[7], gamma=[28], latent_dim=[8],
              num=[1, 2], test_season=[2015, 2016], ode_name=["CONN"])
    kw.update(over)
    return kw


ROW = {"epochs": 60, "gamma": 28, "ode_name": "CONN", "region": "US", "latent_dim": 8,
       "window_size": 7}


@pytest.mark.parametrize("case", ["missing", "filled_and_nan", "other_window", "no_row_keys"])
def test_filter_done_matches_jax(tmp_path, case):
    csv = str(tmp_path / "res.csv")
    axes = resume_configs()
    if case == "filled_and_nan":
        pd.DataFrame([dict(ROW, num=1, **{"2015 13": 1.23, "skill 2015 7": 0.5}),
                      dict(ROW, num=2, **{"2015 13": float("nan"), "skill 2015 7": 0.5})]
                     ).to_csv(csv)
    elif case == "other_window":
        pd.DataFrame([dict(ROW, num=1, **{"2015 13": 1.0})]).to_csv(csv)
        axes = resume_configs(window_size=[15], num=[1], test_season=[2015])
    elif case == "no_row_keys":
        pd.DataFrame([{"num": 1, "2015 13": 1.0}]).to_csv(csv)
    got = [c.key for c in filter_done(grid(**axes), csv)]
    assert got == [c.key for c in jax_filter_done(jax_grid(**axes), csv)]
    if case == "filled_and_nan":
        assert len(got) == 3


def make_grid(who, out, *extra, monkeypatch):
    """The port's ``make_tuning_grid`` or the JAX package's script, in this
    process."""
    argv = ["--out", str(out), "--latent-dims", "4", "--hidden-sizes", "16", "--window-sizes",
            "7", "14", "--batch-sizes", "16", *extra]
    if who == "port":
        make_tuning_grid.main(argv)
        return
    script = os.path.join(REPO, "scripts", "make_tuning_grid.py")
    monkeypatch.setattr(sys, "argv", [script, *argv])
    runpy.run_path(script, run_name="__main__")


def test_make_tuning_grid_and_extend_match_jax(tmp_path, monkeypatch):
    port, jax_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    make_grid("port", port, monkeypatch=monkeypatch)
    make_grid("jax", jax_csv, monkeypatch=monkeypatch)
    frames_equal(port, jax_csv)
    for path in (port, jax_csv):             # score one row, as a worker would
        df = pd.read_csv(path, index_col=0)
        df.loc[0, ["started", "score"]] = [1, -1.5]
        df.to_csv(path)
    make_grid("port", port, "--extend", "--window-sizes", "14", "28", monkeypatch=monkeypatch)
    make_grid("jax", jax_csv, "--extend", "--window-sizes", "14", "28", monkeypatch=monkeypatch)
    frames_equal(port, jax_csv)
    df = pd.read_csv(port, index_col=0)
    assert len(df) == 3 and df.loc[0, "score"] == -1.5 and set(df.window_size) == {7, 14, 28}


# -- the CLIs, with no jax, pandas or filelock -------------------------------------------------

_CLI = textwrap.dedent("""
    import runpy, sys
    for name in ("jax", "pandas", "filelock"):
        sys.modules[name] = None
    import torch
    torch.set_num_threads(1)
    import functools
    from fiude_tpu_torch.data import synthetic
    synthetic.synthetic_dataset = functools.partial(synthetic.synthetic_dataset, n_seasons=2,
                                                    season_len=80)
    from fiude_tpu_torch.utils.config import REGION_INFO
    REGION_INFO["tinycli"] = {{"n_regions": 1, "latent_dim": 8, "n_qs": 3,
        "ode_params": {{"net_sizes": (8, 8), "aug_net_sizes": (8, 8)}}, "dec_params": {{}},
        "enc_params": {{"q_sizes": (12,), "ff_sizes": (8,)}}, "epochs": 4}}
    runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
    assert not any(m in ("fiude_tpu", "pandas", "filelock") or m.startswith(("fiude_tpu.", "jax"))
                   for m in sys.modules if sys.modules[m] is not None)
""")


def clis(*runs):
    """Each ``(name, *args)`` run at once in a subprocess of its own; their
    standard outputs' lines, in order."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI.format(module=f"fiude_tpu_torch.scripts.{name}"), *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, *args in runs]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(out.strip().splitlines())
    return outs


def cli(name, *args):
    return clis((name, *args))[0]


SWEEP = ["--synthetic", "--regions", "tinycli", "--seasons", "2016", "--epochs", "4",
         "--windows", "7", "--gammas", "28", "--device", "cpu"]


def test_run_sweep_and_run_transfer_clis(tmp_path):
    """Two sweeps at once on one work dir (one ledger, one results table), then
    both again beside the transfer from the first one's CONN weights, then the
    transfer again."""
    work = ["--work-dir", str(tmp_path), "--out", "res"]
    conn = ("run_sweep", *SWEEP, *work, "--models", "CONN", "--nums", "1", "--padded",
            "--fused-train")
    pop = ("run_sweep", *SWEEP, *work, "--models", "UONN", "--nums", "2", "3", "--population",
           "--fused-train", "--skip-done")
    transfer = ("run_transfer", "--synthetic", "--regions", "tinycli", "--seasons", "2016",
                "--nums", "1", "--window", "7", "--gamma", "28", "--epochs", "9",
                "--conn-epochs", "4", "--final-epochs", "1", "--work-dir", str(tmp_path),
                "--out", str(tmp_path / "res"), "--device", "cpu")
    first_conn, first_pop = clis(conn, pop)
    assert first_conn[-1] == "processed 1/1 configs"
    assert first_pop[0] == "--skip-done: 0/2 cells already in the results table; 2 to run"
    assert first_pop[-1] == "processed 2/2 configs (population mode)"
    # the second population run leaves --skip-done out: the ledger skips it
    again_conn, again_pop, first_transfer = clis(conn, pop[:-1], transfer)
    assert again_conn[-1] == "processed 0/1 configs"
    assert again_pop[-1] == "processed 0/2 configs (population mode)"
    assert first_transfer[-1] == "processed 1/1 configs"
    assert cli(*transfer)[-1] == "processed 0/1 configs"

    df = pd.read_csv(tmp_path / "res.csv", index_col=0)
    assert sorted(zip(df.ode_name, df.num)) == [("CONN", 1), ("UONN", 2), ("UONN", 3),
                                                ("UONN_pre", 1)]
    assert [c.num for c in filter_done(grid(region=["tinycli"], epochs=[4], window_size=[7],
                                            gamma=[28], num=[2, 3, 4], test_season=[2016],
                                            ode_name=["UONN"]),
                                       str(tmp_path / "res.csv"))] == [4]
    ledger = (tmp_path / "started.txt").read_text().splitlines()
    assert sorted(line.rsplit(" ", 1)[-1] for line in ledger) == ["finished"] * 3
    assert any(line.endswith("_pop2 finished") for line in ledger)


def test_tune_worker_cli(tmp_path):
    csv = tmp_path / "vs.csv"
    make_tuning_grid.main(["--out", str(csv), "--latent-dims", "4", "--hidden-sizes", "8",
                           "--window-sizes", "7", "--batch-sizes", "256", "--n-samples", "4",
                           "--epochs", "1"])
    args = ["3", "--csv", str(csv), "--max-rows", "1", "--device", "cpu"]
    assert cli("tune_worker", *args)[-1] == "worker 3: processed 1 rows"
    assert cli("tune_worker", *args)[-1] == "worker 3: processed 0 rows"
    df = pd.read_csv(csv, index_col=0)
    assert df.loc[0, "platform"] == "cpu" and df.loc[0, "started"] == 1
    assert np.isfinite(df.loc[0, "score"]) and df.loc[0, "score"] != 10.0


def test_clis_refuse_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (run_sweep.main, run_transfer.main, tune_worker.main, rerun_best_tuning.main,
                 tune_encoders.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--synthetic"] if main is run_sweep.main else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep.main(["--synthetic", "--work-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_tune_encoders_make_grid_is_the_jax_file(tmp_path, monkeypatch):
    from scripts import tune_encoders as jax_tune_encoders
    monkeypatch.setattr(sys, "argv", ["tune_encoders.py", "--make-grid", "--csv",
                                      str(tmp_path / "jax.csv")])
    jax_tune_encoders.main()
    tune_encoders.main(["--make-grid", "--csv", str(tmp_path / "port.csv")])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    df = pd.read_csv(tmp_path / "port.csv", index_col=0)
    assert len(df) == 9 and set(df.encoder) == {"back_gru", "bigru", "bilstm"}


def test_tune_encoders_cli(tmp_path):
    """One row an encoder family, a worker over all three (the Back-GRU row
    pre-trained first), then a second worker that finds nothing left."""
    csv = str(tmp_path / "enc.csv")
    rows = [dict(encoder=e, latent_dim=4, hidden_size=4, window_size=15, batch_size=256,
                 n_samples=2, epochs=1, started=0, score=10.0)
            for e in ("back_gru", "bigru", "bilstm")]
    pd.DataFrame(rows).to_csv(csv)
    out = cli("tune_encoders", "2", "--csv", csv, "--device", "cpu")
    assert out[-1] == "worker 2: processed 3 rows"
    assert [line.split(":")[0] for line in out[:-1]] == [
        "back_gru hidden 4", "bigru hidden 4", "bilstm hidden 4"]
    assert cli("tune_encoders", "2", "--csv", csv, "--device", "cpu")[-1] == \
        "worker 2: processed 0 rows"
    df = pd.read_csv(csv, index_col=0)
    assert (df.started == 1).all() and (df.platform == "cpu").all()
    assert np.isfinite(df.score).all() and (df.score != 10.0).all()


@pytest.mark.parametrize("encoder", ["back_gru", "bigru", "bilstm"])
def test_tune_encoders_steps_match_jax(encoder):
    """The model, loss and optimizer a row trains against the JAX script's
    (``scripts/tune_encoders.py:36-52``, transcribed here because its
    ``evaluate`` builds them inside), one step on tied weights and eps."""
    import jax
    import jax.numpy as jnp
    from fiude_tpu.data.synthetic import synthetic_dataset as jax_synthetic
    from fiude_tpu.models import UDEForecaster as JaxForecaster
    from fiude_tpu.train import TRAINING_INFO as JAX_INFO
    from fiude_tpu.train import Trainer as JaxTrainer
    from fiude_tpu.train.checkpoint import tree_to_flat_dict
    from fiude_tpu_torch.train import load_state_from_flat
    from fiude_tpu_torch.train.checkpoint import flat_from_module

    params = dict(encoder=encoder, latent_dim=6, hidden_size=8, window_size=28,
                  batch_size=32, n_samples=4, epochs=1)
    pt, loader, _ = tune_encoders.setup(params, "cpu")
    x_tr, y_tr, _, _, _ = jax_synthetic(n_regions=1, n_qs=8, window_size=28, gamma=28,
                                        run_backward=False, seed=0)
    np.testing.assert_array_equal(loader.x, np.asarray(x_tr))
    jm = JaxForecaster.build(n_regions=1, latent_dim=6, n_qs=8, ode_name="Fp",
                             encoder_name=encoder,
                             enc_params=tune_encoders.enc_params(encoder, 8),
                             ode_params={"net_sizes": (32, 32)})
    jt = JaxTrainer(jm, loss_cfg=JAX_INFO["CONN"], len_tr=max(len(x_tr) // 32, 1))
    jt.setup_training(lr=1e-3)
    assert pt.len_tr == jt.len_tr
    flat = {}
    for part in ("enc", "ode", "dec"):
        flat.update(tree_to_flat_dict(getattr(jt.params, part)))
    load_state_from_flat(pt.model, flat, strict=True)
    rng = np.random.default_rng(3)
    x, y = np.asarray(x_tr[:8], np.float32), np.asarray(y_tr[:8, :28], np.float32)
    t = (np.linspace(1.0, 28, 28) / 7.0).astype(np.float32)
    eps = rng.standard_normal((4, 8, 1, 5)).astype(np.float32)
    jt.state, m_j = jt._step_fn(
        jt.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), jnp.asarray(eps),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(1, jnp.int32),
        jnp.asarray(5000.0, jnp.float32))
    m_t = pt.train_step(torch.from_numpy(x), torch.from_numpy(y), t, torch.from_numpy(eps),
                        epoch=1, grad_lim=5000.0)
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert m_t[k] == pytest.approx(float(m_j[k]), rel=2e-4, abs=1e-7), k
    for part in ("enc", "ode", "dec"):
        want = tree_to_flat_dict(getattr(jt.state.params, part))
        got = flat_from_module(pt.model, part)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
