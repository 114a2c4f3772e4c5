"""The JAX package's probe scripts on the port's probe kernels
(``leftrefill_torch/ops/probes.py``), one module each, on one CUDA GPU:

    python -m leftrefill_torch.tools.probes.r3_attnprobe [--json PATH]   # scripts/tpu_r3_attnprobe.py: P1
    python -m leftrefill_torch.tools.probes.r3_attnprobe2 [--json PATH]  # scripts/tpu_r3_attnprobe2.py: P2
    python -m leftrefill_torch.tools.probes.r5_headpack [--json PATH]    # scripts/tpu_r5_headpack.py: P3
    python -m leftrefill_torch.tools.probes.r5_attn_ab [--json PATH]     # scripts/tpu_r5_attn_ab.py: P4
    python -m leftrefill_torch.tools.probes.r3_overhead [--json PATH]    # scripts/tpu_r3_overhead.py: P5

Each prints the card's name and power limit, then one JSON object a cell:
its times in device ms (``library_baselines.device_ms``: the kernels'
durations in ``torch.profiler``, no host gap counted; ``kernel_ms`` the
probe kernel's alone where its wrapper also runs plain PyTorch ops), after a
warm-up, beside the cell's bound where it has one (``tools.bound_ms``).
The inputs are normal draws from a seeded ``torch.Generator`` on the card,
at the scripts' shapes (the full-width UNet's attention sites: 8192, 2048
and 512 tokens, head dim 64).  Nothing here is on the port's serving or
training path.
"""

from __future__ import annotations

import argparse
import json

import torch

from leftrefill_torch import tools
from leftrefill_torch.tools.library_baselines import device_ms, warm_up


def start(doc: str):
    """Parse ``--json``, require the card, print its line; returns (args,
    card line, seeded generator on the card)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools.probes: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = tools.card_line()
    print(card, flush=True)
    return args, card, torch.Generator("cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def timed(fn, kernel: str | None = None, calls: int = 20) -> float:
    """Device ms a call of ``fn`` after a short warm-up (only the kernels
    named ``kernel``, where given)."""
    warm_up(fn, 0.3)
    return device_ms(fn, calls, kernel=kernel)


def emit(rows: list, **row) -> dict:
    """Print one cell's JSON row and keep it."""
    print(json.dumps(row), flush=True)
    rows.append(row)
    return row


def finish(args, card: str, script: str, rows: list) -> int:
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "torch": torch.__version__, "script": script, "rows": rows}, f, indent=1)
    return 0


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The exact softmax attention in fp64 on q, k, v [..., N, D] (the
    scripts' ``_xla_reference``, to hold a probe's error against)."""
    s = torch.matmul(q.double() * scale, k.double().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1), v.double())


def script_error(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |out - ref|, that over max |ref|): the scripts' parity reading."""
    err = float((out.double() - ref).abs().max())
    return err, err / float(ref.abs().max())
