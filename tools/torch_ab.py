"""Time two trees of the port on one card in one call: parent, this, this,
parent.

PERF.md's "this tree beside its parent" figures come from this script, in
two steps:

    python3 tools/torch_ab.py prepare [--parent REV] [--dir build/ab]

where git is (no card needed): unpacks ``git archive REV`` into
``DIR/parent`` and the working tree, as ``git add -A`` would commit it,
into ``DIR/this`` (through a temporary index: the repository's own index
is untouched).  ``DIR`` must be a directory ``.gitignore`` lists.  Then,
on the card, from the repository root::

    python3 tools/torch_ab.py run [--dir build/ab] [--out build/ab/out]
        [--profile MODE ...]

runs ``python3 chip_smoke.py`` in ``DIR/parent``, ``DIR/this``,
``DIR/this``, ``DIR/parent`` (each run's output to
``OUT/smoke_<tree><k>.txt``; each must exit 0), then
``tools/torch_profile_pipeline.py --modes MODE`` once a tree for each
``MODE`` (default ``arena2 arena fused``; a tiled mode as ``MODE@GRAPH``
adds ``--tiled-graph GRAPH``, e.g. ``tiled2@yolov3-tiny``;
``OUT/prof_<tree>_<mode>.txt``), and prints, for every ``[time]`` figure
that both trees' runs print (the first ``<number> ms`` of the line), each
tree's mean of its two runs and the change, then each profile's
whole-stage, by-kind and per-section lines.  Each tree
builds its kernels in its own ``build/``.  Imports no jax and nothing of
the port.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ORDER = (("parent", 1), ("this", 1), ("this", 2), ("parent", 2))
SMOKE_LIMIT_S = 1200          # chip_smoke.py's own limit on the card
PROFILE_LIMIT_S = 600
_TIME = re.compile(r"^\[time\] (?P<key>[^:]+): (?:.*?)(?P<ms>\d+\.\d+) ms")
_PROFILE = re.compile(r"^\[(arena|fused)\] (by kind|N=\d+: whole stage)"
                      r"|^\[sections\] |^ +\d+\.\d+ ms \( *\d+\.\d+%\)  section ")


def prepare(parent: str, out: Path) -> None:
    """``git archive parent`` into out/parent and the working tree (as
    ``git add -A`` would commit it) into out/this."""
    for name in ("parent", "this"):
        if (out / name).exists():
            raise SystemExit(f"torch_ab: {out / name} exists; remove it first")
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, GIT_INDEX_FILE=os.path.join(tmp, "index"))
        subprocess.run(["git", "add", "-A"], cwd=ROOT, env=env, check=True)
        tree = subprocess.run(["git", "write-tree"], cwd=ROOT, env=env,
                              check=True, capture_output=True,
                              text=True).stdout.strip()
    for name, rev in (("parent", parent), ("this", tree)):
        (out / name).mkdir(parents=True)
        archive = subprocess.run(["git", "archive", rev], cwd=ROOT,
                                 check=True, capture_output=True).stdout
        subprocess.run(["tar", "-x", "-C", str(out / name)], input=archive,
                       check=True)
        print(f"[ab] {out / name}: {rev}", flush=True)


def parse_times(text: str) -> dict:
    """{key: ms} of a chip_smoke.py output's ``[time]`` lines: the text
    before the first ``: `` and the first ``<number> ms`` after it."""
    got = {}
    for line in text.splitlines():
        m = _TIME.match(line)
        if m:
            got[m["key"]] = float(m["ms"])
    return got


def compare(runs: dict) -> list:
    """Lines of each key that every run of both trees has: each tree's
    mean of its runs, then the change of this against parent."""
    keys = [k for k in runs[("parent", 1)]
            if all(k in r for r in runs.values())]
    lines = []
    for k in keys:
        mean = {}
        for tree in ("parent", "this"):
            v = [r[k] for (t, _), r in runs.items() if t == tree]
            mean[tree] = sum(v) / len(v)
            mean[tree + "_runs"] = ", ".join(f"{x:.4f}" for x in v)
        change = (mean["this"] / mean["parent"] - 1) * 100 \
            if mean["parent"] else float("nan")
        lines.append(f"[ab] {k}: parent {mean['parent']:.4f} ms "
                     f"({mean['parent_runs']}), this {mean['this']:.4f} ms "
                     f"({mean['this_runs']}), {change:+.2f}%")
    return lines


def _run(cmd, cwd: Path, log: Path, limit: int) -> str:
    print(f"[ab] {cwd.name}: {' '.join(cmd)} > {log}", flush=True)
    with open(log, "w") as f:
        res = subprocess.run(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                             timeout=limit)
    text = log.read_text()
    if res.returncode != 0:
        raise SystemExit(f"torch_ab: {' '.join(cmd)} in {cwd} exited "
                         f"{res.returncode}; see {log}")
    return text


def run(trees: Path, out: Path, modes) -> None:
    out.mkdir(parents=True, exist_ok=True)
    runs = {}
    for tree, k in ORDER:
        text = _run([sys.executable, "chip_smoke.py"], trees / tree,
                    out / f"smoke_{tree}{k}.txt", SMOKE_LIMIT_S)
        runs[(tree, k)] = parse_times(text)
    for line in compare(runs):
        print(line, flush=True)
    for spec in modes:
        mode, _, graph = spec.partition("@")
        args = ["--modes", mode] + (["--tiled-graph", graph] if graph else [])
        for tree in ("parent", "this"):
            text = _run([sys.executable, "tools/torch_profile_pipeline.py",
                         *args], trees / tree,
                        out / f"prof_{tree}_{mode}{'_' + graph if graph else ''}"
                        ".txt", PROFILE_LIMIT_S)
            for line in text.splitlines():
                if _PROFILE.match(line):
                    print(f"[ab] profile {spec} {tree}: {line}",
                          flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="step", required=True)
    p = sub.add_parser("prepare")
    p.add_argument("--parent", default="HEAD")
    p.add_argument("--dir", default="build/ab")
    r = sub.add_parser("run")
    r.add_argument("--dir", default="build/ab")
    r.add_argument("--out", default="build/ab/out")
    r.add_argument("--profile", nargs="*", default=["arena2", "arena",
                                                    "fused"])
    args = ap.parse_args(argv)
    if args.step == "prepare":
        prepare(args.parent, ROOT / args.dir)
    else:
        run(ROOT / args.dir, ROOT / args.out, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
