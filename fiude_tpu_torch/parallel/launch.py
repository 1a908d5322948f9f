"""Start a world of ranks on one machine and collect what each returns.

:func:`run_world` starts ``n_ranks`` processes (the ``forkserver`` start
method: each is forked from one server process, made once for the caller's
life, that has imported ``torch`` and the rank-side modules and touched no
card; each imports the function it runs by name, so it must be a
module-level function of the package), makes their process group through a
``FileStore`` in a fresh directory (so worlds started at once never race for
a port), runs ``fn(*args)`` on every rank and returns the ranks' results in
rank order.
A rank that raises, or a world that outlives ``timeout``, stops every rank
and raises here: a rank that never reaches a collective would otherwise hang
its peers for good.  Each rank's process group also carries a timeout
(``distributed.TIMEOUT``).

This is how the CPU tests, ``dryrun.dryrun_multichip`` and ``chip_smoke.py``
rehearse the sharded paths; ``torchrun`` starts the ranks of a real run.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union


#: What the server that forks the ranks imports once (it starts no card).
PRELOAD = ["torch", "fiude_tpu_torch.parallel.rehearsal"]


def _rank_main(rank: int, n_ranks: int, url: str, backend: Optional[str], device: str,
               timeout_s: float, fn: Callable, args: tuple, results) -> None:
    import torch
    from fiude_tpu_torch.parallel import distributed

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        distributed.initialize(url, n_ranks, rank, backend=backend, device=device,
                               timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_world(n_ranks: int, fn: Callable, *args: Any, device: Union[str, Sequence[str]] = "cpu",
              backend: Optional[str] = None, timeout: float = 600.0) -> List[Any]:
    """``fn(*args)`` on each of ``n_ranks`` ranks; their results in rank order.

    ``device``: every rank's device, or one a rank (``distributed.
    initialize``'s ``device``); ``backend``: the process group's (NCCL on a
    card, gloo on the CPU when None).  Raises when a rank raises or when the
    world takes longer than ``timeout`` seconds."""
    devices = [device] * n_ranks if isinstance(device, str) else list(device)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="fiude_world_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, f"file://{store}/store", backend, devices[r],
                               timeout, fn, args, results))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        got = {}
        while len(got) < n_ranks:
            try:
                wait = min(max(deadline - time.monotonic(), 0.1), 5.0)
                rank, ok, value = results.get(timeout=wait)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and not p.is_alive()]
                if dead or time.monotonic() >= deadline:
                    raise RuntimeError(f"rank(s) {dead or sorted(set(range(n_ranks)) - set(got))}"
                                       f" returned nothing within {timeout:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(n_ranks)]
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(10)
            if p.is_alive():
                p.kill()
        results.close()
        shutil.rmtree(store, ignore_errors=True)
