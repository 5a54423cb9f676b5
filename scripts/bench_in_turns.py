"""Run one kernel bench module against several checkouts in turns, on one card.

    python scripts/bench_in_turns.py MODULE [--arg ARG ...] TREE [TREE ...]

For example, a parent and a change in turns (the parent unpacked with
``git archive`` into a directory that ``.gitignore`` lists):

    python scripts/bench_in_turns.py repro_torch.kernels.ssm_scan.bench \
        --arg=--bwd build/parent . . build/parent

MODULE names a bench module of this checkout's ``src/``. Its source, from
this checkout, runs as ``__main__`` with the ARGs, once for each TREE in the
order given, in a fresh process whose ``repro_torch`` is that TREE's own
(``TREE/src`` on the path, the TREE its working directory): every tree is
timed by the same harness and builds its own kernels under its ``build/``.
Prints, for each run, the last line the module printed (one JSON object)
with ``"tree"`` added. Exits with the first failing run's code.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
RUN = "import runpy, sys; sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("module", help="a bench module, e.g. repro_torch.kernels.ssm_scan.bench")
    parser.add_argument("trees", nargs="+", help="checkout roots, in the order to run them")
    parser.add_argument("--arg", action="append", default=[], help="an argument for the module")
    args = parser.parse_args(argv)
    source = SRC / (args.module.replace(".", "/") + ".py")
    if not source.is_file():
        raise SystemExit(f"no module {args.module} under {SRC}")
    for tree in args.trees:
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run([sys.executable, "-c", RUN, str(source), *args.arg], cwd=root,
                              env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(json.dumps({"tree": tree, **json.loads(proc.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
