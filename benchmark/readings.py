"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... [--seconds 2] [--program-control <mode>]

One process, one set-up.  For each of ``--seeds`` the program runs a
short window at the cell's own load and its kept batches are judged as a
run judges them: the program's readings, of which the largest over a
dozen seeds or more is a limit's lower reading.  For each of
``--control-seeds`` the control is judged at the cell's own size: the
reference with its weights on the int4 grid (the precision below the
configuration's int8) put in the program's place.  ``--program-control``
also judges the program in another of its modes (the exact cells: its
float32 requant path, ``arena2``) against the cell's reference.  The
smallest control reading is a limit's upper reading.  One JSON line a
reading, then the summary.
"""

import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(s: dict, seeds, control_seeds, seconds: float, device,
             program_control: str = None, batch: int = None):
    """Yield one dict a reading (see the module's docstring)."""
    import torch

    from benchmark.harness import cell, frames, window, work

    config, traffic = s["config"], s["traffic"]
    device = torch.device(device)
    graph = work.graph_of(config, ROOT)
    program = cell.program_of(config, traffic, device)
    inflight, keep = traffic["inflight"], cell.CHECK_BATCHES
    for seed in seeds:
        pool = frames.make_pool(traffic, config, seed, device, batch)
        cell._warm(program, pool, 2, inflight + keep)
        sample = window.Reservoir(keep, random.Random(seed))
        window.run(program, pool, inflight, seconds, device, sample)
        kept = sorted(sample.items, key=lambda item: item[0])
        values, seen, _ = cell.judge_kept(
            config, traffic, graph, kept, dict(enumerate(pool)), device)
        del pool, sample, kept
        yield {"kind": "program", "seed": seed, "values": values,
               "seen": seen}
    del program
    other = None
    if program_control:
        other = cell.program_of(config, {**traffic, "mode": program_control},
                                device)
    for seed in control_seeds:
        pool = frames.make_pool(traffic, config, seed, device, batch)
        kept = [(i, None) for i in range(len(pool))]
        values, seen, _ = cell.judge_kept(
            config, traffic, graph, kept, dict(enumerate(pool)), device,
            control={"weight_bits": 4})
        yield {"kind": "control_int4", "seed": seed, "values": values,
               "seen": seen}
        if other is not None:
            kept = [(i, other(pool[i])) for i in range(len(pool))]
            values, seen, _ = cell.judge_kept(
                config, traffic, graph, kept, dict(enumerate(pool)), device)
            yield {"kind": f"control_{program_control}", "seed": seed,
                   "values": values, "seen": seen}
        del pool, kept


def summary(rows) -> dict:
    """The largest program reading and the smallest control reading of
    each number."""
    out = {}
    for r in rows:
        low = r["kind"] == "program"
        for k, v in r["values"].items():
            slot = out.setdefault(k, {"lower": None, "upper": None})
            key = "lower" if low else "upper"
            cur = slot[key]
            slot[key] = v if cur is None else (max(cur, v) if low
                                               else min(cur, v))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program-control", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell

    if not torch.cuda.is_available():
        print("readings.py: needs a CUDA card", file=sys.stderr)
        return 2
    rows = []
    t0 = time.perf_counter()
    for r in readings(cell.spec(args.workload), args.seeds,
                      args.control_seeds, args.seconds, "cuda:0",
                      args.program_control):
        r["t_s"] = round(time.perf_counter() - t0, 1)
        rows.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
