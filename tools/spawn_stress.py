#!/usr/bin/env python3
"""Run a test file's K-rank gloo group many times over, several groups at
once, and count the spawns in which a rank failed.

    python3 tools/spawn_stress.py [--file tests/test_torch_ring.py]
        [--ranks 4] [--spawns 64] [--concurrent 8]

Each spawn starts the file as ``--ranks`` rank processes (argv: rank, K,
directory), as ``tests/test_torch_parallel.py``'s ``spawn_ranks`` does,
with their output in files, and records every rank's return code and the
tail of the standard error of any that failed. ``--concurrent`` groups run
at the same time, to load the host as the test runner's workers do. Prints
one line a failed spawn and a JSON summary last. CPU only; no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spawn(script: str, k: int, timeout: float) -> dict:
    with tempfile.TemporaryDirectory(prefix="spawn_stress_") as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                     "MASTER_PORT", "XLA_FLAGS"):
            env.pop(name, None)
        procs = []
        for rank in range(k):
            with open(f"{tmp}/out{rank}", "w") as fo, \
                    open(f"{tmp}/err{rank}", "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, script, str(rank), str(k), tmp],
                    cwd=ROOT, env=env, stdout=fo, stderr=fe,
                    stdin=subprocess.DEVNULL))
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        errors = {rank: Path(f"{tmp}/err{rank}").read_text()[-300:]
                  for rank, code in enumerate(codes) if code}
        return {"codes": codes, "errors": errors}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--file", default="tests/test_torch_ring.py")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--spawns", type=int, default=64)
    parser.add_argument("--concurrent", type=int, default=8)
    parser.add_argument("--timeout", type=float, default=240.0)
    args = parser.parse_args()
    script = str(ROOT / args.file)
    failed = 0
    with ThreadPoolExecutor(args.concurrent) as pool:
        for result in pool.map(lambda _: spawn(script, args.ranks,
                                               args.timeout),
                               range(args.spawns)):
            if any(result["codes"]):
                failed += 1
                print(json.dumps(result), flush=True)
    print(json.dumps({"file": args.file, "ranks": args.ranks,
                      "spawns": args.spawns, "failed": failed}))


if __name__ == "__main__":
    main()
