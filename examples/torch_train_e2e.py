"""End-to-end training driver on the port: train a ~100M-parameter dense
model with the paper's communication phase enabled (bucketed gradient sync,
optionally compressed), checkpointing as it goes.  The counterpart of
``examples/train_e2e.py``.

It registers ``repro-100m`` in the port's config registry with the
reference's widths, and drives ``repro_torch.launch.train.main`` with
``--comm-mode explicit``.  The sequence length reaches the trainer as
``--seq-len`` (the reference overwrites ``INPUT_SHAPES["train_4k"]``
process-wide instead).  It asserts that the loss falls.

The defaults (30 steps, S 256, batch 4) are the reference's; ``--steps 300``
is the few-hundred-step run on the card.  On a CUDA device the step takes
the float32 flash kernel (``csrc/flash_attn.cu``, head dim 64, on the tensor
cores in 3xTF32) and the codec kernels of ``--compression``.

Run:  python examples/torch_train_e2e.py --steps 300 --compression int8
      python examples/torch_train_e2e.py --device cpu --steps 3 --seq-len 64 --batch 2
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import register  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402


@register("repro-100m")
def repro_100m() -> ModelConfig:
    """~100M-param llama-style dense config for the e2e example (the
    reference's, field for field)."""
    return ModelConfig(
        name="repro-100m", family="dense", num_layers=8, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000,
        attn_chunk=256, logit_chunk=256, dtype="float32", remat=False,
        sharding="dp_tp", source="examples/train_e2e.py")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python examples/torch_train_e2e.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--compression", default="none",
                    choices=["none", "fp16", "int8", "ternary", "topk"])
    ap.add_argument("--topk-ratio", type=float, default=0.01)
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "repro_torch_e2e_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--use-pallas", default="", choices=["", "auto", "always", "never"],
                    help="kernel dispatch (never: the plain versions)")
    return ap


def train_argv(args) -> List[str]:
    """The trainer's command line for these arguments."""
    argv = ["--arch", "repro-100m", "--shape", "train_4k", "--seq-len", str(args.seq_len),
            "--steps", str(args.steps), "--batch", str(args.batch),
            "--comm-mode", "explicit", "--compression", args.compression,
            "--topk-ratio", str(args.topk_ratio), "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", str(args.ckpt_every), "--log-every", str(args.log_every),
            "--device", args.device]
    return argv + (["--use-pallas", args.use_pallas] if args.use_pallas else [])


def main(argv: Optional[List[str]] = None, params: Any = None) -> Dict:
    """Train, assert that the loss fell, and return the trainer's result.
    ``params`` replace the random initial parameters (on the device)."""
    from repro_torch.launch import train as train_mod

    args = build_parser().parse_args(argv)
    result = train_mod.main(train_argv(args), params)
    assert result["loss_decreased"], "loss must decrease over the run"
    print(f"[e2e] OK — loss {result['first_loss']:.3f} -> {result['last_loss']:.3f}")
    return result


if __name__ == "__main__":
    main()
