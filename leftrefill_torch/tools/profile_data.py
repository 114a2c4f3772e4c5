"""Where the host's training data path spends its time: ``cProfile`` of the
novel-view and MegaDepth datasets' items, on the machine it runs on (no GPU
needed).

    python -m leftrefill_torch.tools.profile_data [--json PATH]

The NVS dataset is :func:`tools.nvs_train_dataset` (``NVS_OBJDataset`` with
the shipped novel-view data config on seeded 256x256 renders), the MegaDepth
dataset :func:`tools.megadepth_train_dataset` (``InpaintingCrossViewDataset``
with the 1-reference data config on a seeded tree of the 1600x1200 4:2:0
photo), the two that ``profile_request --train --nvs | --megadepth`` time
beside the step.  For each it prints, and writes to PATH as one JSON
object: the seconds per item on one thread without the profiler (after one
warm-up item, which builds the native image layer), the seconds of the
profiled items (``NVS_ITEMS`` and ``MEGADEPTH_ITEMS``), and the ``TOP``
functions by own time (calls, own seconds, cumulative seconds, each
function as ``file:line(name)``), with the host CPU's model name.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import shutil
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NVS_ITEMS = 16
MEGADEPTH_ITEMS = 8
TOP = 25


def _top(profile: cProfile.Profile) -> list:
    stats = pstats.Stats(profile).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:TOP]
    out = []
    for (path, line, name), (_, calls, own, cum, _) in rows:
        where = os.path.relpath(path, REPO) if path.startswith(str(REPO)) else os.path.basename(path)
        out.append({"function": f"{where}:{line}({name})", "calls": calls, "own_s": own, "cum_s": cum})
    return out


def profile_items(ds, indices: list) -> dict:
    """One warm-up item, the items of ``indices`` timed, then the same items
    profiled."""
    ds[indices[0]]
    t0 = time.perf_counter()
    for i in indices:
        ds[i]
    plain_s = (time.perf_counter() - t0) / len(indices)
    profile = cProfile.Profile()
    t0 = time.perf_counter()
    profile.enable()
    for i in indices:
        ds[i]
    profile.disable()
    return {"items": len(indices), "seconds_per_item_one_thread": plain_s,
            "profiled_seconds": time.perf_counter() - t0, "top_by_own_time": _top(profile)}


def main() -> int:
    from leftrefill_torch import tools

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args()
    result = {"host_cpu": tools.host_cpu()}
    root = tempfile.mkdtemp(prefix="profile_data_")
    try:
        result["nvs"] = profile_items(tools.nvs_train_dataset(os.path.join(root, "nvs")), list(range(NVS_ITEMS)))
        ds, indices = tools.megadepth_train_dataset(os.path.join(root, "megadepth"))
        result["megadepth"] = profile_items(ds, indices[:MEGADEPTH_ITEMS])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"host: {result['host_cpu']}")
    for key in ("nvs", "megadepth"):
        rec = result[key]
        print(f"{key}: {rec['items']} items, seconds_per_item_one_thread={rec['seconds_per_item_one_thread']:.4f}, "
              f"profiled {rec['profiled_seconds']:.3f} s")
        for row in rec["top_by_own_time"]:
            print(f"  {row['own_s']:9.4f} own {row['cum_s']:9.4f} cum {row['calls']:8d} calls  {row['function']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
