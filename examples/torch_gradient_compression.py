"""Gradient-compression training demo on the port (paper §3.2 as a runtime
feature): the counterpart of ``examples/gradient_compression.py``.

Trains the same smoke model under every compression mode of the explicit
(Horovod-style) communication phase and compares the loss trajectories:
compression trades model quality for wire time, so it pays only on slow
networks.  It keeps the reference's checks: every loss falls, and fp16
ends within 0.15 of the uncompressed run.

Run:  python examples/torch_gradient_compression.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MODES = ("none", "fp16", "int8", "topk")


def train_argv(compression: str, device: str, steps: int = 10) -> List[str]:
    return ["--arch", "stablelm-3b", "--smoke", "--steps", str(steps),
            "--comm-mode", "explicit", "--compression", compression,
            "--topk-ratio", "0.25", "--log-every", "100", "--device", device]


def main(argv: Optional[List[str]] = None, params: Any = None) -> Dict[str, Dict]:
    """Each mode's trainer result, by mode.  ``params`` replace the random
    initial parameters of every run (on the device; each run trains a copy,
    since the optimizer updates in place)."""
    import torch

    from repro_torch.launch import train as train_mod
    from repro_torch.utils.tree import tree_map

    ap = argparse.ArgumentParser(prog="python examples/torch_gradient_compression.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = {mode: train_mod.main(train_argv(mode, args.device),
                                    None if params is None else tree_map(torch.clone, params))
               for mode in MODES}

    print(f"\n{'mode':<8} {'loss_0':>8} {'loss_N':>8} {'decreased':>10}")
    base = results["none"]["last_loss"]
    for mode, r in results.items():
        print(f"{mode:<8} {r['first_loss']:>8.4f} {r['last_loss']:>8.4f} "
              f"{str(r['loss_decreased']):>10}")
        assert r["loss_decreased"], f"{mode}: loss must decrease"
    # lossless/lossy ordering sanity: fp16 tracks none closely
    assert abs(results["fp16"]["last_loss"] - base) < 0.15
    print("\nAll compression modes converge; fp16 tracks the uncompressed trajectory (paper: "
          "lossy compression is the only mode that risks model quality — use it only when "
          "the wire demands it).")
    return results


if __name__ == "__main__":
    main()
