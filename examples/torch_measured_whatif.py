#!/usr/bin/env python3
"""White-box measured what-if on a GPU: the paper's section 3.1 method run
end to end on one of its own workloads, in PyTorch.

Counterpart of ``examples/measured_whatif.py``:

1. time a real fwd+bwd of VGG-16 (or ResNet-50/101, ``--model``) on this
   device;
2. spread the measured batch time into a gradient-ready timeline with
   ``timeline.from_cnn`` (per-layer FLOP shares of the backward, as the
   paper spreads its hook timings);
3. price it with the simulator across bandwidths (64 workers, ideal
   transport), beside the same model with the V100 batch time the paper's
   simulator uses, and then under each comm schedule (``horovod_tcp``).

On the card it runs at the paper's setting by default: full width, batch
32, 224x224 images, 1,000 classes, float32.  The V100 times are float32, so
the measured ``t_batch`` is taken with TF32 off for both the convolutions
(``torch.backends.cudnn.allow_tf32``) and the matmuls
(``torch.backends.cuda.matmul.allow_tf32``); a TF32 reading of the same
step, the speed a user of the card sees with PyTorch's convolution default,
is printed on a line of its own.  The reference's reduced VGG (``--width
0.25 --batch 4 --classes 100``) is a size for the CPU.

Run:  PYTHONPATH=src python examples/torch_measured_whatif.py [--model resnet50]
      PYTHONPATH=src python examples/torch_measured_whatif.py --device cpu \\
          --width 0.0625 --batch 2 --classes 10 --repeats 1
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.cnn_profiles import get_profile  # noqa: E402
from repro_torch.core.simulator import simulate  # noqa: E402
from repro_torch.core.timeline import from_cnn  # noqa: E402
from repro_torch.core.transport import GBPS  # noqa: E402
from repro_torch.launch.train import resolve_device  # noqa: E402
from repro_torch.models.cnn import CNN_NAMES, cnn_loss, get_cnn  # noqa: E402
from repro_torch.utils.tree import value_and_grad  # noqa: E402

BANDWIDTHS_GBPS = (10, 25, 100)
SCHEDULERS = ("fifo", "priority", "chunked")
# NVIDIA H100 SXM data sheet, dense: float32 on the CUDA cores, TF32 on the
# tensor cores.  The bounds below are the FLOPs of one fwd+bwd (3x the
# forward's, from core/cnn_profiles) over these peaks.
H100_F32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12


@contextlib.contextmanager
def tf32(enabled: bool):
    """Set both TF32 switches (convolutions, matmuls) and restore them."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def measure_step(name: str = "vgg16", width_mult: float = 1.0, batch: int = 32,
                 repeats: int = 5, device="cuda", *, num_classes: int = 1000,
                 warmup: int = 2, hw: int = 224) -> float:
    """Median seconds of one fwd+bwd of ``cnn_loss`` (``repeats`` of them,
    after ``warmup``), each timed by the host clock around work that ends in
    a synchronise on CUDA.  Seed-0 parameters; images from seed 1, labels 0,
    as the reference.  The caller sets the TF32 switches (:func:`tf32`)."""
    device = resolve_device(device)
    params, forward = get_cnn(name, torch.Generator(device=device).manual_seed(0),
                              num_classes, width_mult)
    data = {"images": torch.randn(batch, hw, hw, 3, device=device,
                                  generator=torch.Generator(device=device).manual_seed(1)),
            "labels": torch.zeros(batch, dtype=torch.long, device=device)}

    def step():
        value_and_grad(lambda p, b: (cnn_loss(forward, p, b), {}), params, data)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        step()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def fwd_bwd_flops(name: str, batch: int) -> float:
    """FLOPs of one fwd+bwd at full width and 224x224: 3x the forward's."""
    return 3.0 * batch * sum(l.flops for l in get_profile(name).layers)


def scaling_table(name: str, t_batches: dict, n_workers: int = 64) -> dict:
    """Scaling factor at each bandwidth, ideal transport: label -> {Gbps: f}."""
    out = {}
    for label, t_batch in t_batches.items():
        tl = from_cnn(name, t_batch=t_batch)
        out[label] = {bw: simulate(tl, n_workers=n_workers, bandwidth=bw * GBPS,
                                   transport="ideal").scaling_factor
                      for bw in BANDWIDTHS_GBPS}
    return out


def scheduler_table(name: str, t_batch, n_workers: int = 64) -> dict:
    """Scaling factor per scheduler and bandwidth, horovod_tcp transport."""
    tl = from_cnn(name, t_batch=t_batch)
    return {sched: {bw: simulate(tl, n_workers=n_workers, bandwidth=bw * GBPS,
                                 transport="horovod_tcp", scheduler=sched).scaling_factor
                    for bw in BANDWIDTHS_GBPS}
            for sched in SCHEDULERS}


def _print_rows(rows: dict, width: int = 14) -> None:
    print(f"  {'':<{width}}" + "".join(f"  {bw:>3}Gbps" for bw in BANDWIDTHS_GBPS))
    for label, by_bw in rows.items():
        print(f"  {label:<{width}}" + "".join(f"  {by_bw[bw]:7.1%}" for bw in BANDWIDTHS_GBPS))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="vgg16", choices=CNN_NAMES)
    ap.add_argument("--width", type=float, default=1.0, help="width multiplier")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is none) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name, prof = args.model, get_profile(args.model)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    setting = (f"width {args.width}, batch {args.batch}, 224x224, {args.classes} classes, "
               f"float32")
    measure = dict(width_mult=args.width, batch=args.batch, repeats=args.repeats,
                   device=device, num_classes=args.classes, warmup=args.warmup)

    with tf32(False):
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        t_f32 = measure_step(name, **measure)
    print(f"measured {name} fwd+bwd on {kind} ({setting}; cudnn.allow_tf32={flags[0]}, "
          f"cuda.matmul.allow_tf32={flags[1]}): t_batch {t_f32 * 1e3:.2f} ms (median of "
          f"{args.repeats}), {args.batch / t_f32:.1f} images/s; paper V100 constant "
          f"{prof.t_batch_v100 * 1e3:.2f} ms ({32 / prof.t_batch_v100:.0f} images/s at batch 32)")
    t_batches = {"paper-V100": None, "this-device": t_f32}
    result = {"model": name, "device": kind, "batch": args.batch, "width": args.width,
              "t_batch_f32": t_f32, "t_batch_v100": prof.t_batch_v100}
    if device.type == "cuda":
        with tf32(True):
            t_tf32 = measure_step(name, **measure)
        print(f"  TF32 reading (cudnn.allow_tf32=True, cuda.matmul.allow_tf32=True): t_batch "
              f"{t_tf32 * 1e3:.2f} ms, {args.batch / t_tf32:.1f} images/s")
        t_batches["this-dev-tf32"] = t_tf32
        result["t_batch_tf32"] = t_tf32
        if args.width == 1.0:
            flops = fwd_bwd_flops(name, args.batch)
            result["bound_f32"] = flops / H100_F32_FLOPS
            result["bound_tf32"] = flops / H100_TF32_FLOPS
            print(f"  H100 compute bounds ({flops / 1e12:.3f} TFLOP a fwd+bwd): f32 "
                  f"{result['bound_f32'] * 1e3:.2f} ms at 67 TFLOP/s, TF32 "
                  f"{result['bound_tf32'] * 1e3:.2f} ms at 495 TFLOP/s")

    # the timeline keeps the full-width model's layer sizes: the measured time
    # stands for that model only at --width 1 --batch 32
    print(f"\nscaling factor, {name} timeline, 64 workers, ideal transport:")
    result["scaling"] = scaling_table(name, t_batches)
    _print_rows(result["scaling"])
    print("\nFaster compute hides less communication -> lower scaling factor at equal "
          "bandwidth,\nthe compute/comm balance the paper's what-if captures.")

    print(f"\nscheduler x bandwidth ({name}, horovod_tcp transport, 64 GPUs):")
    result["schedulers"] = {}
    for label in ("paper-V100", "this-device"):
        result["schedulers"][label] = scheduler_table(name, t_batches[label])
        print(f" {label} timeline:")
        _print_rows(result["schedulers"][label], width=10)
    print("\nA better schedule recovers bandwidth the serialized loop leaves idle -- the "
          "paper's point\nthat scheduling, not the network, is the bottleneck.")
    return result


if __name__ == "__main__":
    main()
