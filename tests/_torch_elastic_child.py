"""One process of a port CLI run under a fault plan or in an elastic world.

    python tests/_torch_elastic_child.py [--tiny-vit] [--settle S]
        [--claim-after FILE] [--await-claim] [--setup-stall S] -- ARGS

runs ``python -m distributedpytorch_tpu_torch ARGS`` in this process,
after shrinking the elastic module's waits (``SETTLE_S``, ``WORLD_WAIT_S``
and ``RENDEZVOUS_DEADLINE_S``) so that a test's rendezvous takes seconds,
and with ``--tiny-vit`` after narrowing the registry's vit to 2 blocks of
width 32 (2 heads).  The parent sets the env:// variables (WORLD_SIZE,
RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) for a rank
of a launched world, and none of them for an ``--elastic-join`` process.
``--claim-after FILE`` holds an ``--elastic-join`` process's claim back
until FILE exists: the process can start with the world, and only its
claim, not its start-up, races the world's epochs.  ``--await-claim``
makes the first health boundary's join scan wait (up to 60 s) until a
join claim is pending, so that the world grows at its first boundary.
``--setup-stall S`` sleeps S seconds at the start of the process's
dataset load, after its world has formed: a member whose own set-up
outlasts ``--health-timeout``.  Exits with the CLI's code.

    python tests/_torch_elastic_child.py --probe flags|timeout OUT.json

is one rank of a 2-rank gloo world (env:// variables set) that writes
what it saw to OUT.json: ``flags`` runs ``runtime.agree_health`` over
CASES, then rank 1 vanishes (``os._exit(113)``) in the fourth step of a
DDP model and rank 0 records the type and text of the error its backward
raised and of its next agreement's; ``timeout`` bounds the agreement by
2 s while rank 1 arrives 4 s late, and each rank records the error and
the seconds it took.  ``tests/test_torch_elastic.py`` and
``tests/test_torch_chaos.py`` run it on the CPU, ``chip_smoke.py`` on the
card.  Imports no JAX.
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributedpytorch_tpu_torch import cli, elastic  # noqa: E402
from distributedpytorch_tpu_torch.models import vit  # noqa: E402

TINY_VIT = dict(dim=32, depth=2, heads=2)
# (failed, shutdown, grow) of rank 0 and of rank 1, per agreement
CASES = [((0, 0, 0), (0, 0, 0)), ((1, 0, 0), (0, 0, 0)),
         ((0, 0, 0), (0, 1, 0)), ((0, 0, 1), (0, 0, 0)),
         ((1, 1, 0), (0, 0, 1)), ((1, 1, 1), (1, 1, 1))]
TIMEOUT_S = 2.0
LATE_S = 4.0


def _error(e: BaseException) -> dict:
    return {"types": [t.__name__ for t in type(e).__mro__], "text": str(e)}


def probe(mode: str, out: str) -> int:
    """One rank of the probe worlds (see the module docstring)."""
    import torch
    import torch.distributed as dist

    from distributedpytorch_tpu_torch import faults, runtime

    device = torch.device("cpu")
    runtime.initialize_distributed(device)
    rank = runtime.process_index()
    got = {}
    if mode == "flags":
        got["agree"] = [runtime.agree_health(f, s, grow=g)
                        for f, s, g in (case[rank] for case in CASES)]
        torch.manual_seed(0)
        model = torch.nn.parallel.DistributedDataParallel(
            torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.ReLU(),
                                torch.nn.Linear(256, 10)))
        try:
            for step in range(50):
                if rank == 1 and step == 3:
                    os._exit(113)
                model(torch.randn(32, 64)).sum().backward()
        except Exception as e:
            got["backward"] = _error(e)
        try:
            runtime.agree_health(False, False)
        except Exception as e:
            got["agree_after"] = _error(e)
    else:
        runtime.health_group(TIMEOUT_S)
        dist.barrier()
        if rank == 1:
            time.sleep(LATE_S)
        t0 = time.monotonic()
        try:
            runtime.agree_health(False, False, timeout_s=TIMEOUT_S)
        except Exception as e:
            got["error"] = _error(e)
            got["timeout"] = isinstance(e, faults.HealthTimeoutError)
        got["seconds"] = time.monotonic() - t0
    with open(out, "w") as f:
        json.dump(got, f)
    os._exit(0)     # the peer may be gone: no group teardown


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tiny-vit", action="store_true")
    p.add_argument("--settle", type=float, default=2.0)
    p.add_argument("--claim-after", metavar="FILE")
    p.add_argument("--await-claim", action="store_true")
    p.add_argument("--setup-stall", type=float, default=0.0)
    p.add_argument("--probe", nargs=2, metavar=("MODE", "OUT"))
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args()
    if a.probe:
        return probe(*a.probe)
    args = a.args[1:] if a.args[:1] == ["--"] else a.args
    elastic.SETTLE_S = a.settle
    elastic.WORLD_WAIT_S = 60.0
    elastic.RENDEZVOUS_DEADLINE_S = 60.0
    if a.claim_after:
        claim = elastic.request_join

        def held_claim(elastic_dir):
            while not os.path.exists(a.claim_after):
                time.sleep(0.05)
            return claim(elastic_dir)

        elastic.request_join = held_claim
    if a.await_claim:
        scan = elastic.scan_joins

        def awaited_scan(elastic_dir, *rest):
            deadline = time.monotonic() + 60.0
            while not elastic.pending_joins(elastic_dir) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            elastic.scan_joins = scan
            return scan(elastic_dir, *rest)

        elastic.scan_joins = awaited_scan
    if a.setup_stall:
        load = cli.load_dataset

        def stalled_load(*args, **kwargs):
            time.sleep(a.setup_stall)
            return load(*args, **kwargs)

        cli.load_dataset = stalled_load
    if a.tiny_vit:
        vit.ViT.__init__ = functools.partialmethod(vit.ViT.__init__,
                                                   **TINY_VIT)
    return cli.main(args)


if __name__ == "__main__":
    sys.exit(main())
