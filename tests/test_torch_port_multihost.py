"""Multi-process rehearsal of the port: a real 2-process ``torch.distributed``
CPU world through a TCP coordinator, the counterpart of
``tests/test_multihost.py``: ``parallel/distributed.py``'s hooks, a broadcast
from rank 0 and the port's ``Ledger`` + ``run_work_queue`` racing over 12
units; the sweep command's ``--population`` over two groups on 2 ranks under
``torchrun --standalone`` (which binds its own port), each group claimed
once, each row written once; and ``dryrun_multichip`` on 2 ranks.  The
population command and the dry run start with the module and run beside the
other tests.  The ranks block ``jax`` and ``fiude_tpu``."""
import concurrent.futures
import csv
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = "import sys\nsys.modules['jax'] = None\nsys.modules['fiude_tpu'] = None\n"

WORKER = BLOCK + textwrap.dedent("""
    import json, os
    import torch
    import torch.distributed as dist
    from fiude_tpu_torch.ops.collectives import broadcast_
    from fiude_tpu_torch.parallel import distributed
    from fiude_tpu_torch.parallel.sweep import run_work_queue
    from fiude_tpu_torch.utils.ledger import Ledger

    pid = int(sys.argv[1]); coord = sys.argv[2]; work = sys.argv[3]
    torch.set_num_threads(1)
    assert distributed.initialize(coordinator_address=coord, num_processes=2, process_id=pid,
                                  device="cpu")
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    assert dist.get_backend() == "gloo"
    assert distributed.is_primary_host() == (pid == 0)

    # every rank sees rank 0's values
    got = broadcast_(torch.tensor([100.0 + pid]), dist.group.WORLD)
    assert float(got[0]) == 100.0, got
    assert distributed.broadcast_from_primary({"from": pid}) == {"from": 0}

    @distributed.primary_only
    def write_marker():
        with open(os.path.join(work, "primary.txt"), "a") as fh:
            fh.write(f"host{pid}\\n")
        return "wrote"
    assert (write_marker() == "wrote") == (pid == 0)

    class C:
        def __init__(self, i): self.key = f"unit{i}"
    led = Ledger(os.path.join(work, "started.txt"))
    results = run_work_queue([C(i) for i in range(12)], lambda c: {"host": pid, "key": c.key},
                             ledger=led)
    with open(os.path.join(work, f"wins_{pid}.json"), "w") as fh:
        json.dump([r["key"] for r in results if r], fh)
    dist.barrier()
    distributed.shutdown()
""")

# the sweep command on a tiny region preset, as torchrun would start a rank
SWEEP = BLOCK + textwrap.dedent("""
    import runpy
    import torch
    from fiude_tpu_torch.utils.config import REGION_INFO
    torch.set_num_threads(1)
    REGION_INFO["tinymh"] = {"n_regions": 1, "latent_dim": 6, "n_qs": 3,
                             "ode_params": {"net_sizes": (8, 8), "aug_net_sizes": (8, 8)},
                             "dec_params": {}, "enc_params": {"q_sizes": (12,), "ff_sizes": (8,)},
                             "epochs": 4}
    runpy.run_module("fiude_tpu_torch.scripts.run_sweep", run_name="__main__", alter_sys=True)
""")
SWEEP_ARGS = ("--synthetic", "--population", "--fused-train", "--regions", "tinymh",
              "--models", "CONN", "--seasons", "2016", "2017", "--epochs", "4", "--windows",
              "7", "--gammas", "28", "--nums", "3", "4", "--device", "cpu", "--out", "res")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(procs, timeout=240):
    """Wait for ``procs`` (killing them past ``timeout`` seconds); their outputs."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}"
    return outs


def _env():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    return env


def test_two_process_world(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    _run([subprocess.Popen([sys.executable, str(script), str(pid), coord, str(tmp_path)],
                           env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True) for pid in (0, 1)])
    with open(tmp_path / "primary.txt") as fh:
        assert fh.read() == "host0\n"
    wins = [json.load(open(tmp_path / f"wins_{pid}.json")) for pid in (0, 1)]
    assert set(wins[0]).isdisjoint(wins[1])
    assert sorted(wins[0] + wins[1]) == sorted(f"unit{i}" for i in range(12))
    with open(tmp_path / "started.txt") as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 12 and all(line.endswith(" finished") for line in lines)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The population command (under ``torchrun``) and the 2-rank dry run,
    started with the module: {"sweep": (process, work dir), "dryrun": future}."""
    from fiude_tpu_torch.parallel.dryrun import dryrun_multichip

    work = tmp_path_factory.mktemp("population")
    script = work / "sweep.py"
    script.write_text(SWEEP)
    sweep = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "--tee", "3", str(script), *SWEEP_ARGS, "--work-dir", str(work)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        yield {"sweep": (sweep, work), "dryrun": pool.submit(dryrun_multichip, 2)}
    finally:
        if sweep.poll() is None:
            sweep.kill()
            sweep.wait()
        pool.shutdown(wait=True)


def test_population_command_over_two_ranks(background):
    """``run_sweep --population`` over two groups on a 2-rank torchrun world:
    the config mesh made once, rank 0 claims each group once, the members
    train one a rank, rank 0 writes each row once."""
    proc, work = background["sweep"]
    out, = _run([proc])
    lines = out.splitlines()
    rank0 = [ln.split(":", 1)[1] for ln in lines if ln.startswith("[default0]:")]
    rank1 = [ln.split(":", 1)[1] for ln in lines if ln.startswith("[default1]:")]
    assert "processed 4/4 configs (population mode)" in rank0
    assert not any("processed" in ln for ln in rank1)
    assert rank0.count("config mesh of 2 ranks") == 1
    assert sum(ln.startswith("population:") for ln in rank0) == 2
    with open(work / "res.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert sorted(r["num"] for r in rows) == ["3", "4"]
    assert all(r["2016 13"] and r["2017 13"] for r in rows)
    with open(work / "started.txt") as fh:
        claims = fh.read().splitlines()
    assert len(claims) == 2 and all(c.endswith("_pop2 finished") for c in claims)
    for season in (2016, 2017):
        for n in (3, 4):
            assert (work / "weights" / "tinymh" / "CONN" /
                    f"{season}_e4_g28_w7_{n}_enc.npz").exists()


def test_dryrun_multichip_on_two_ranks(background):
    """Every sharded path of the dry run on 2 CPU ranks: finite numbers, the
    Bayes step with its ``ode_kl`` term."""
    out = background["dryrun"].result(timeout=600)
    assert out["axes"] == (("sample", 2), ("data", 1))
    assert all(np.isfinite(out[k]) for k in ("loss", "fused_loss", "serving_sum", "bayes_loss"))
    assert out["bayes_has_ode_kl"]


@pytest.fixture
def no_world(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_without_a_world_does_nothing(no_world):
    from fiude_tpu_torch.parallel import distributed
    assert distributed.initialize(device="cpu") is False
    assert distributed.is_primary_host() and distributed.world_size() == 1


@pytest.mark.parametrize("kwargs,error,match", [
    ({"device": "cpu"}, ValueError, "world size"),
    ({"device": "cpu", "num_processes": 1, "process_id": 0, "backend": "nccl"}, ValueError,
     "NCCL backend needs a CUDA device"),
    ({"num_processes": 1, "process_id": 0}, RuntimeError, "no CUDA device"),
])
def test_initialize_refuses_what_it_cannot_do(kwargs, error, match, no_world, monkeypatch):
    """A coordinator without a rank; NCCL on the CPU; a card asked for (no
    ``device``) where there is none: each raises, none falls back."""
    from fiude_tpu_torch.parallel import distributed
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(error, match=match):
        distributed.initialize("127.0.0.1:1", **kwargs)
