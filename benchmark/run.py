"""The benchmark of the PyTorch / CUDA port on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the checkout's root: set-up (the
weights and frames drawn on the card from the seed, the program built and
warmed), the measured window (``--trace 0``: the cell's end-to-end metrics)
or a bounded traced stretch (``--trace 1``: its per-layer metrics), then the
comparison with the plain reference that decides ``correct``. The last line
on standard output is the result object; the last lines on standard error
are the compared numbers beside their limits. ``--control 1`` puts the
reference, one precision step lower, in the program's place (no window):
the comparison has to come out false.

Exits non-zero with no result without a card, or when a module of the JAX
side was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import core, spec

    cell = spec.resolve(args.workload)
    need = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        core.log(f"needs {need} CUDA device(s); torch.cuda.is_available() = "
                 f"{torch.cuda.is_available()}, device_count = "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = core.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   control=bool(args.control))
    card = core.power_limit()
    if card:
        core.log(f"card: {card}")
    core.log(f"set-up {getattr(res['ctx'], 'setup_s', float('nan')):.3f} s, check "
             f"{res['check_s']:.3f} s")
    core.emit(core.result_line(cell, res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
