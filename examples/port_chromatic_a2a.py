"""Schedule an MoE expert-dispatch all-to-all with graph coloring, on the
port (the counterpart of ``examples/chromatic_a2a.py``).

The classical collective-scheduling application: transfers (src, dst) of a
full all-to-all conflict when they share an endpoint; edge-coloring the
communication graph with the paper's engine yields conflict-free rounds.
Compares the greedy-colored schedule against the optimal round-robin
(P-1 rounds) and simulates both on a store-and-forward link model.

    PYTHONPATH=src python examples/port_chromatic_a2a.py --devices 8
    PYTHONPATH=src python examples/port_chromatic_a2a.py --device cpu

``--devices`` is the size of the simulated all-to-all; ``--device`` is where
the coloring engine runs.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core.scheduling import all_to_all_rounds  # noqa: E402


def simulate(rounds, msg_us=10.0):
    """Each round costs one message time (all transfers in parallel)."""
    return len(rounds) * msg_us


def round_robin(P):
    return [[(i, (i + r) % P) for i in range(P)] for r in range(1, P)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    P = args.devices

    colored = all_to_all_rounds(P, device=torch.device(args.device))
    optimal = round_robin(P)
    print(f"all-to-all among {P} devices: {P*(P-1)} transfers")
    print(f"  greedy-colored schedule: {len(colored)} rounds "
          f"({simulate(colored):.0f}us simulated)")
    print(f"  optimal round-robin:     {len(optimal)} rounds "
          f"({simulate(optimal):.0f}us simulated)")
    print(f"  efficiency: {len(optimal)/len(colored):.2%}")
    for i, rnd in enumerate(colored[:4]):
        print(f"  round {i}: {sorted(rnd)}")
    if len(colored) > 4:
        print(f"  ... {len(colored) - 4} more rounds")


if __name__ == "__main__":
    main()
