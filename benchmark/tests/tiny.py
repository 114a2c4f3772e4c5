"""A copy of the benchmark's folder with cells of CPU size beside the real
ones: the configurations of ``data/``, traffic mixes of a few steps, and the
real cells' limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REAL = {"t.predict": "ref1_bf16.predict_n4", "t.train": "ref1_bf16.train_b8", "t.scene": "mv4_bf16.scene_x2"}
TRAFFIC = {
    "t_predict": {"driver": "predict", "img_size": 64, "num_samples": 2, "ddim_steps": 2, "scale": 2.5,
                  "hole_share": [0.2, 0.5], "pool": 3, "trace_units": 1},
    "t_train": {"driver": "train", "batch": 2, "img_size": 64, "pool": 4, "trace_units": 2},
    "t_scene": {"driver": "scene", "scenes": 2, "img_size": 32, "ddim_steps": 2, "scale": 2.5,
                "hole_share": [0.25, 0.5], "pool": 2, "trace_units": 1},
}


def spec() -> dict:
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def tiny_copy(root: Path) -> tuple[Path, dict]:
    """(the copied folder, a spec whose cells are the tiny ones)."""
    base = root / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("tiny_ref1", "tiny_mv2"):
        shutil.copy(HERE / "data" / f"{name}.json", base / "configs" / f"{name}.json")
    for name, t in TRAFFIC.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for tiny, real in REAL.items():
        shutil.copy(base / "checks" / f"{real}.json", base / "checks" / f"{tiny}.json")
    s = spec()
    s["configs"] += [{"name": "tiny_ref1"}, {"name": "tiny_mv2"}]
    s["workloads"] = [{"name": "t.predict", "config": "tiny_ref1", "traffic": "t_predict", "chips": 1},
                      {"name": "t.train", "config": "tiny_ref1", "traffic": "t_train", "chips": 1},
                      {"name": "t.scene", "config": "tiny_mv2", "traffic": "t_scene", "chips": 1}]
    for m in s["end_to_end"] + s["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [t for t, r in REAL.items() if r in m["workloads"]]
    return base, s
