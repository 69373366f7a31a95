"""Training launcher of the port — the ``--arch gtl_paper`` path of
``repro.launch.train``: the paper's reproduction on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gtl_paper
    PYTHONPATH=src python -m repro_torch.launch.train --arch gtl_paper \\
        --scenario mnist_balanced --samples 3000 --device cuda --kernel cuda

Prints ``scenario=...``, one ``F=`` line per summary row and the overhead
gains, as the reference does.  Language-model training (any other
``--arch``) is not ported yet: it exits non-zero.
"""
from __future__ import annotations

import argparse


def run_gtl_paper(args):
    """--arch gtl_paper: the faithful reproduction path."""
    from repro_torch.core.experiment import run_scenario

    r = run_scenario(args.scenario, n_samples=args.samples,
                     kernel=args.kernel, device=args.device)
    print(f"scenario={r.name}")
    for name, f in r.summary_rows():
        print(f"  {name:14s} F={f:.3f}")
    g = r.overhead.gains()
    print("  overhead:", {k: round(v, 3) for k, v in g.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scenario", default="hapt")
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel", default="cuda", choices=["cuda", "torch"])
    args = ap.parse_args(argv)

    if args.arch in ("gtl_paper", "gtl-paper"):
        return run_gtl_paper(args)
    ap.exit(2, f"{ap.prog}: --arch {args.arch}: language-model training is "
               f"not ported yet (slice 6b of ROADMAP.md); only --arch "
               f"gtl_paper runs\n")


if __name__ == "__main__":
    main()
