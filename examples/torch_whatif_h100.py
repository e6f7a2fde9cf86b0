"""Beyond-paper example: the paper's what-if analysis asked of H100
clusters for the port's architectures.

Counterpart of ``examples/whatif_tpu.py``.  For data-parallel training of
each architecture (one replica a GPU computing S = 4096, batch 1, as the
port's trainer does) on 8, 64 and 256 H100s (NVLink inside a node of 8,
InfiniBand at 400 Gbps a GPU across nodes), is the network the bottleneck,
and does compression help?  Compute is priced at an assumed MFU of 0.4 of
the H100's dense bf16 rate; ``chip_smoke.py`` prints the same question for
stablelm-3b at the MFU its measured trainer step reaches.  The larger
models (jamba-v0.1-52b, command-r-35b, deepseek-coder-33b, deepseek-v2-236b,
arctic-480b: 60 GB to 900 GB of bf16 weights) do not fit one card with
their optimizer state, yet their rows here price one replica a GPU all the
same: a layout the port cannot run.  The reference's table
(``examples/whatif_tpu.py``) prices another layout for every model it
lists: ``tpu_whatif``'s default 16-way data-parallel group, the other chips
in a model-parallel group that shards the compute and the gradients
(16-way on 256 chips in one pod, 8-way when they are two pods).

Run:  PYTHONPATH=src python examples/torch_whatif_h100.py
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.configs.archs import ALL_ARCHS  # noqa: E402
from repro_torch.core.whatif import h100_whatif  # noqa: E402

# one replica's step in the port's trainer (launch/train.py, chip_smoke.py)
TRAIN_SHAPE = InputShape("train_4k_b1", 4096, 1, "train")
N_GPUS = (8, 64, 256)
RATIOS = (1.0, 4.0)


def main() -> list:
    rows = []
    print(f"{'arch':<16} {'gpus':>5} {'comp':>5} {'f_sim':>7} {'overhead':>10}")
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for n in N_GPUS:
            for ratio in RATIOS:
                r = h100_whatif(cfg, TRAIN_SHAPE, n_gpus=n,
                                compression_ratio=ratio)
                rows.append(dict(arch=arch, n_gpus=n, ratio=ratio,
                                 scaling=r.scaling_factor,
                                 t_overhead=r.t_overhead))
                print(f"{arch:<16} {n:>5} {ratio:>4.0f}x "
                      f"{r.scaling_factor:>6.1%} {r.t_overhead*1e3:>8.2f}ms")
    print("\nReading: inside one node NVLink keeps the sync near-invisible; "
          "across nodes the\nInfiniBand stage is where compression starts "
          "to matter.")
    return rows


if __name__ == "__main__":
    main()
