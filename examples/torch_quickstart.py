"""Quickstart of the PyTorch port: the paper's question, *is the network
the bottleneck?*, answered end to end with ``repro_torch`` in seconds on
the CPU (the simulator touches no tensor).

Counterpart of ``examples/quickstart.py``, with the same rows:

1. the time to transmit each of the paper's three CNNs' parameters;
2. the what-if simulator at measured-transport vs full utilization;
3. gradient compression at 10 Gbps.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import whatif  # noqa: E402
from repro_torch.core.whatif import sim_scaling  # noqa: E402

BANDWIDTHS = (10, 25, 100)
RATIOS = (1, 2, 5, 10)


def main() -> dict:
    print("=" * 72)
    print("Paper reproduction: 'Is Network the Bottleneck of Distributed "
          "Training?' (PyTorch port)")
    print("=" * 72)

    print("\n-- transmission time of all parameters at 100 Gbps "
          "(paper: 7.8 / 13.6 / 42.2 ms) --")
    table = whatif.transmission_table()
    for row in table:
        print(f"  {row['model']:<10} {row['size_mb']:6.1f} MB  "
              f"{row['time_ms']:5.1f} ms")

    print("\n-- scaling factor, 8 servers (64 GPUs) --")
    print(f"  {'model':<10} {'bw':>6} {'measured-mode':>14} {'full-util':>10}")
    scaling = {}
    for model in whatif.PAPER_MODELS:
        for bw in BANDWIDTHS:
            meas = sim_scaling(model, bandwidth_gbps=bw,
                               transport="horovod_tcp").scaling_factor
            ideal = sim_scaling(model, bandwidth_gbps=bw,
                                transport="ideal").scaling_factor
            scaling[(model, bw)] = (meas, ideal)
            print(f"  {model:<10} {bw:>4}G {meas:>13.1%} {ideal:>10.1%}")

    print("\n-- gradient compression at 10 Gbps, full utilization "
          "(paper: 2-5x is enough; VGG16 needs ~10x) --")
    compression = {}
    for model in whatif.PAPER_MODELS:
        line = f"  {model:<10}"
        for ratio in RATIOS:
            f = sim_scaling(model, bandwidth_gbps=10, transport="ideal",
                            compression_ratio=ratio).scaling_factor
            compression[(model, ratio)] = f
            line += f"  {ratio}x={f:.1%}"
        print(line)

    print("\nConclusion (paper §4): with the network fully utilized the "
          "scaling factor is ~100% at 100 Gbps —\nthe bottleneck is the "
          "transport implementation, not the network speed.")
    return {"transmission": table, "scaling": scaling,
            "compression": compression}


if __name__ == "__main__":
    main()
