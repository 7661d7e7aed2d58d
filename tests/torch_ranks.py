"""Run a program on N CPU ranks of a gloo process group, the port's twin of
the JAX tests' forced host devices (``run_in_devices`` in
tests/test_distributed.py), and collect its per-check results.

``run(code, world, tmp)`` writes ``PRELUDE + code`` to ``tmp/ranks.py``,
starts ``world`` processes of it (rank i of world, a ``file://``
rendezvous in ``tmp``, so parallel test workers never share a port) and
waits for all of them within ``timeout`` seconds, killing every one on
expiry (the program imports ``src`` and this directory's helpers, as
``init_annot_from``).  The program registers checks with ``check(name, fn)``: each runs
``fn`` and records whether it raised; every rank writes its record to
``tmp/rank<i>.json``.  ``run`` returns ``{name: [(rank, ok, detail),
...]}``, so one job serves many parametrised tests, each reading its
check.  The process group's own timeout (60 s) turns one rank's failure
into an error on the others instead of a hang."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"

PRELUDE = '''
import json, sys, traceback
from datetime import timedelta
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{TMP}/rendezvous",
                        rank=RANK, world_size=WORLD,
                        timeout=timedelta(seconds=60))
RESULTS = {}


def check(name, fn):
    """Run ``fn()``; record (ok, its return value or the traceback)."""
    try:
        RESULTS[name] = [True, repr(fn())]
    except Exception:
        RESULTS[name] = [False, traceback.format_exc()[-3000:]]


def finish():
    with open(f"{TMP}/rank{RANK}.json", "w") as f:
        json.dump(RESULTS, f)
    dist.destroy_process_group()

'''


def run(code: str, world: int, tmp: Path, timeout: float = 300.0
        ) -> dict[str, list[tuple[int, bool, str]]]:
    """Run ``code`` (which ends by calling ``finish()``) on ``world``
    ranks; the checks' results by name, one entry a rank."""
    tmp = Path(tmp)
    script = tmp / "ranks.py"
    script.write_text(PRELUDE + code, encoding="utf-8")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), str(tmp)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise
    finally:
        for f in logs:
            f.close()
    results: dict[str, list[tuple[int, bool, str]]] = {}
    for r, p in enumerate(procs):
        out = tmp / f"rank{r}.json"
        if p.returncode != 0 or not out.exists():
            log = (tmp / f"rank{r}.log").read_text(errors="replace")
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{log[-3000:]}")
        for name, (ok, detail) in json.loads(out.read_text()).items():
            results.setdefault(name, []).append((r, ok, detail))
    return results


def assert_held(results: dict, name: str, world: int) -> None:
    """Every rank ran check ``name`` and none raised."""
    got = results.get(name, [])
    failed = [f"rank {r}: {detail}" for r, ok, detail in got if not ok]
    assert not failed, "\n".join(failed)
    assert len(got) == world, f"{name}: {len(got)} of {world} ranks ran it"


def init_annot_from(trees: dict):
    """A ``registry.Model.init_annot`` that gives ``trees[cfg.name]`` (a
    plain parameter tree: another package's weights, converted) with the
    model's own logical axes, in place of its draw; patched in, it feeds
    those weights to every entry point that draws (the trainer)."""
    from repro_torch import partitioning as pt
    from repro_torch.optim.adamw import tree_map

    def annotated(values, axes):
        if isinstance(values, dict):
            return {k: annotated(values[k], axes[k]) for k in values}
        if isinstance(values, list):
            return [annotated(v, a) for v, a in zip(values, axes,
                                                    strict=True)]
        return pt.Annot(values, axes)

    def init_annot(self, gen, device="cpu"):
        return annotated(tree_map(lambda t: t.to(device),
                                  trees[self.cfg.name]),
                         self.abstract_params()[1])
    return init_annot
