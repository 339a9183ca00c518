"""Diff the port's dry-run records of two commits, field by field.

    PYTHONPATH=src python scripts/torch_dryrun_diff.py --parent HEAD~1 \
        [--jobs 4]

Runs ``python -m repro_torch.launch.dryrun --all`` twice on the CPU (the
fake backend, meta tensors): once from the ``src/`` of ``--parent``
(unpacked with ``git archive`` under ``build/dryrun_diff/``), once from
this checkout's ``src/``. Then it compares the two sets of records: the
same cell names, and in each record every field but ``IGNORED``
(``collectives``, which a commit may add, and ``count_s``, a wall time)
equal, nested fields and numbers exactly. Prints each
difference and a summary line; exits 1 if any field differs.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tarfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
IGNORED = ("collectives", "count_s")


def unpack(rev: str, dest: Path) -> Path:
    """``rev``'s ``src/`` tree under ``dest`` (``git archive``)."""
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    tar = subprocess.run(["git", "archive", rev, "src"], cwd=ROOT,
                         check=True, capture_output=True).stdout
    with tarfile.open(fileobj=io.BytesIO(tar)) as t:
        t.extractall(dest, filter="data")
    return dest / "src"


def sweep(src: Path, out: Path, jobs: int) -> float:
    """The dry run's ``--all`` sweep with ``src`` first on the path; its
    records under ``out``. Returns its wall seconds."""
    shutil.rmtree(out, ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = str(src)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--all", "--jobs", str(jobs), "--out", str(out)],
                   cwd=src.parent, env=env, check=True,
                   stdout=subprocess.DEVNULL)
    return time.perf_counter() - t0


def records(out: Path) -> dict:
    return {p.name: json.loads(p.read_text()) for p in sorted(
        out.glob("*.json"))}


def diff(a, b, path: str, out: list):
    """Every path at which ``a`` and ``b`` differ, appended to ``out``."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                out.append(f"{path}/{k}: only in "
                           f"{'the change' if k in b else 'the parent'}")
            else:
                diff(a[k], b[k], f"{path}/{k}", out)
    elif a != b:
        out.append(f"{path}: {a!r} -> {b!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="HEAD~1",
                    help="the commit whose records are the reference")
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args(argv)
    work = ROOT / "build" / "dryrun_diff"
    rev = subprocess.run(["git", "rev-parse", "--short", args.parent],
                         cwd=ROOT, check=True, capture_output=True,
                         text=True).stdout.strip()
    secs = {"parent": sweep(unpack(args.parent, work / "parent"),
                            work / "parent_records", args.jobs),
            "change": sweep(ROOT / "src", work / "change_records",
                            args.jobs)}
    old, new = records(work / "parent_records"), records(
        work / "change_records")
    found = []
    for name in sorted(set(old) | set(new)):
        if name not in old or name not in new:
            found.append(f"{name}: only in "
                         f"{'the change' if name in new else 'the parent'}")
            continue
        a, b = ({k: v for k, v in r.items() if k not in IGNORED}
                for r in (old[name], new[name]))
        diff(a, b, name, found)
    for line in found:
        print(line)
    added = sum("collectives" in r and "collectives" not in old.get(n, {})
                for n, r in new.items())
    print(f"dry-run records: parent {rev} {len(old)} ({secs['parent']:.0f} "
          f"s), change {len(new)} ({secs['change']:.0f} s); fields compared "
          f"but {', '.join(IGNORED)}: {len(found)} difference(s); "
          f"{added} change record(s) carry collectives the parent's lack")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
