"""Batched serving example on the port: prefill a prompt batch and decode
continuations for three architecture families (dense GQA, attention-free
RWKV-6, encoder-decoder Whisper) through ``repro_torch.launch.serve.main``:
the counterpart of ``examples/serve_batch.py``.  On a CUDA device rwkv6's
prefill and decode steps take the WKV kernels, the decoders' attention the
flash kernel where the shape qualifies.

Run:  python examples/torch_serve_batch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCHS = ("stablelm-3b", "rwkv6-1.6b", "whisper-base")


def serve_argv(arch: str, device: str) -> List[str]:
    return ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "32", "--gen", "8",
            "--device", device]


def main(argv: Optional[List[str]] = None, params: Optional[Dict] = None) -> Dict[str, Dict]:
    """Each architecture's serving result, by name.  ``params``: a tree
    (on the device) by architecture, in place of the random one."""
    from repro_torch.launch import serve as serve_mod

    ap = argparse.ArgumentParser(prog="python examples/torch_serve_batch.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return {arch: serve_mod.main(serve_argv(arch, args.device), (params or {}).get(arch))
            for arch in ARCHS}


if __name__ == "__main__":
    main()
