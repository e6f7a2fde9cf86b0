"""Gradient-compression codecs as priced pipeline stages.

Counterpart of ``repro/core/codec.py``, and priced exactly as it: the same
wire ratios, pass constants and table, so every codec gets the same
``Codec`` in both packages.  A codec is a wire ratio (what the bytes shrink
to) **plus** calibrated encode/decode compute costs:

- ``none``         identity; zero cost, ratio 1;
- ``ratio[:r]``    the parametric byte divisor: wire ratio ``r``, zero
                   compute cost (the legacy ``compression_ratio`` float);
- ``int8``         per-256-block absmax int8 quantization (the kernel pair
                   ``quantize_int8_2d`` / ``dequantize_int8_2d``);
- ``ternary``      TernGrad ternarization (``ternarize_2d``), wire format 2
                   bits/element packed plus a per-block scale;
- ``topk[:r]``     DGC-style magnitude sparsification to wire ratio ``r``.

Cost model: encode/decode are element-wise streaming kernels, priced like
:class:`~repro_torch.core.addest.AddEst`: a launch overhead per bucket and
stage plus *memory passes* over the gradient bytes at the modelled
device's memory rate.  The pass counts are measured against a copy probe
of the same launch shape (machine speed cancels in the ratio).  By default
the table is ``artifacts/bench/BENCH_codec.json``, the reference's, priced
on the V100.  The table measured on the H100 by
``benchmarks/torch_kernel_bench.py --calibrate`` is
:data:`H100_TABLE_PATH`; a codec priced on the H100 is::

    replace(get_codec(spec, table=load_codec_table(str(H100_TABLE_PATH))),
            mem_bw=H100_MEM_BW, launch_overhead=H100_LAUNCH_OVERHEAD)
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.core.addest import V100_LAUNCH_OVERHEAD, V100_MEM_BW

# wire formats, from the kernels' block layout (BLOCK = 256 f32 elements):
# int8 emits 256 int8 values + one f32 scale per block; ternary packs
# 2 bits/element + one f32 scale per block.
_BLOCK_BYTES = 256 * 4
INT8_WIRE_RATIO = _BLOCK_BYTES / (256 + 4)          # ~3.94x
TERNARY_WIRE_RATIO = _BLOCK_BYTES / (256 // 4 + 4)  # ~15.06x

# the calibration probe is a copy kernel of the codec kernels' launch shape:
# one read + one write per byte, so one "pass" moves 2 bytes of memory traffic
PROBE_BYTES_PER_BYTE = 2.0

# error feedback (EF-SGD) keeps a per-bucket residual: the encoder reads
# gradient + residual, writes the compensated gradient, and writes the new
# residual back — ~3 extra probe-passes of streaming traffic per encode
ERROR_FEEDBACK_PASSES = 3.0

# Hivemind's size-adaptive idiom (SNIPPETS.md snippet 1): buckets at or
# above the threshold get the real codec, smaller ones go uncompressed
# (their wire time is negotiation-dominated; compute would be pure loss)
SIZE_ADAPTIVE = "size-adaptive"
SIZE_ADAPTIVE_THRESHOLD = float(2 ** 16 + 1)         # bytes

# committed calibration (see module docstring): probe-normalized memory
# passes per codec stage.  MUST stay equal to the ``codecs`` section of
# artifacts/bench/BENCH_codec.json (tests/test_torch_calibration.py pins it).
FALLBACK_PASSES: Dict[str, Dict[str, float]] = {
    "int8": {"encode": 1.088, "decode": 0.304},
    "ternary": {"encode": 0.906, "decode": 0.232},
    "topk": {"encode": 0.939, "decode": 1.0},
}

TABLE_PATH = Path(__file__).resolve().parents[3] / "artifacts" / "bench" / \
    "BENCH_codec.json"
# the same codecs measured on an H100 at a bandwidth-bound size
H100_TABLE_PATH = TABLE_PATH.with_name("BENCH_codec_h100.json")


@lru_cache(maxsize=1)
def load_codec_table(path: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """The committed calibration table (pass counts per codec stage).

    Reads ``artifacts/bench/BENCH_codec.json`` when the repo checkout is
    present, else falls back to :data:`FALLBACK_PASSES` (pinned equal by
    test, so both paths price codecs identically)."""
    p = Path(path) if path else TABLE_PATH
    try:
        table = json.loads(p.read_text())["codecs"]
        return {k: {"encode": float(v["encode_passes"]),
                    "decode": float(v["decode_passes"])}
                for k, v in table.items()}
    except (OSError, KeyError, ValueError):
        return FALLBACK_PASSES


@dataclass(frozen=True)
class Codec:
    """A priced compression codec: wire ratio + calibrated compute passes.

    ``encode_passes``/``decode_passes`` are probe-normalized memory passes
    over the *uncompressed* bytes (see module docstring); the device-scale
    seconds come from :meth:`encode_seconds`/:meth:`decode_seconds` at the
    modeled V100 memory bandwidth, plus :attr:`launch_overhead` once per
    bucket per stage (charged by the lowering on each bucket's first
    chunk).  A ``free`` codec (both pass counts zero) is the legacy byte
    divisor and must leave the lowering's arithmetic untouched.
    """

    name: str                     # canonical instance name, e.g. "topk:8"
    kind: str                     # base codec: none|ratio|int8|ternary|topk
    wire_ratio: float             # uncompressed bytes / wire bytes
    encode_passes: float = 0.0    # probe-normalized memory passes
    decode_passes: float = 0.0
    mem_bw: float = V100_MEM_BW
    launch_overhead: float = V100_LAUNCH_OVERHEAD

    @property
    def is_free(self) -> bool:
        return self.encode_passes == 0.0 and self.decode_passes == 0.0

    def encode_seconds(self, nbytes: float) -> float:
        """Linear encode cost of ``nbytes`` uncompressed gradient bytes
        (launch overhead is charged separately, once per bucket).

        Pure scalar arithmetic, so a numpy array of sizes broadcasts
        elementwise, bit-identical to the per-op scalar calls."""
        return (self.encode_passes * PROBE_BYTES_PER_BYTE * nbytes
                / self.mem_bw)

    def decode_seconds(self, nbytes: float) -> float:
        return (self.decode_passes * PROBE_BYTES_PER_BYTE * nbytes
                / self.mem_bw)

    def with_error_feedback(self) -> "Codec":
        """EF-SGD residual accumulation: extra encode-side memory traffic."""
        if self.is_free:
            raise ValueError(
                f"error feedback needs a lossy codec, got {self.name!r} "
                f"(the free byte divisor has no residual to feed back)")
        return replace(self, name=self.name + "+ef",
                       encode_passes=self.encode_passes
                       + ERROR_FEEDBACK_PASSES)


NONE_CODEC = Codec(name="none", kind="none", wire_ratio=1.0)


def parse_codec(spec: str) -> Tuple[str, Optional[float]]:
    """``"name[:param]"`` -> ``(name, param-or-None)``."""
    if ":" in spec:
        base, _, raw = spec.partition(":")
        try:
            return base, float(raw)
        except ValueError:
            raise ValueError(f"bad codec parameter in {spec!r}") from None
    return spec, None


def get_codec(spec: str, *, compression_ratio: float = 1.0,
              table: Optional[Dict[str, Dict[str, float]]] = None) -> Codec:
    """Resolve a codec string (plus the legacy ``compression_ratio`` float)
    into a priced :class:`Codec`.

    - ``none`` with ``compression_ratio != 1`` routes through the
      parametric ``ratio`` codec (zero compute) — the deprecated
      ``NetworkModel.compression_ratio`` path, bit-identical by
      construction since the ratio float lands unchanged in the cost
      model;
    - ``ratio``/``topk`` take their ratio from the ``:param`` suffix, or
      fall back to ``compression_ratio``;
    - fixed-format codecs (``int8``, ``ternary``) refuse a non-unit
      ``compression_ratio`` — their wire ratio is intrinsic.
    """
    base, param = parse_codec(spec)
    passes = table if table is not None else load_codec_table()

    def _kernel(kind: str, ratio: float, name: str) -> Codec:
        p = passes[kind]
        return Codec(name=name, kind=kind, wire_ratio=float(ratio),
                     encode_passes=p["encode"], decode_passes=p["decode"])

    if base == "none":
        if param is not None:
            raise ValueError(f"codec 'none' takes no parameter: {spec!r}")
        if compression_ratio != 1.0:
            return Codec(name=f"ratio:{compression_ratio:g}", kind="ratio",
                         wire_ratio=float(compression_ratio))
        return NONE_CODEC
    if base == "ratio":
        r = param if param is not None else compression_ratio
        return Codec(name=f"ratio:{r:g}", kind="ratio", wire_ratio=float(r))
    if base in ("int8", "ternary"):
        if param is not None:
            raise ValueError(f"codec {base!r} takes no parameter: {spec!r}")
        if compression_ratio != 1.0:
            raise ValueError(
                f"codec {base!r} has an intrinsic wire ratio; it does not "
                f"compose with compression_ratio={compression_ratio:g}")
        ratio = INT8_WIRE_RATIO if base == "int8" else TERNARY_WIRE_RATIO
        return _kernel(base, ratio, base)
    if base == "topk":
        r = param if param is not None else compression_ratio
        return _kernel("topk", r, f"topk:{r:g}")
    known = "none, ratio[:r], int8, ternary, topk[:r], " + SIZE_ADAPTIVE
    raise ValueError(f"unknown codec {spec!r}; known: {known}")


# ---------------------------------------------------------------------------
# regime classification (fig13)
# ---------------------------------------------------------------------------

REGIME_WINS = "wins"
REGIME_LOSES = "loses"
REGIME_PURE_OVERHEAD = "pure-overhead"
REGIME_NEUTRAL = "neutral"

# baseline overhead below this fraction of t_batch means there was nothing
# for compression to win (the paper's "no compression needed at 100 Gbps")
_NOTHING_TO_WIN = 0.01


def classify_regime(overhead_codec: float, overhead_none: float,
                    t_batch: float, codec_compute: float,
                    eps: float = 1e-6) -> str:
    """fig13's cell classification: does compression *win*, *lose*, or is
    it *pure overhead* against the same cell run uncompressed?

    - ``pure-overhead``: the baseline was already compute-bound (overhead
      under 1% of t_batch), so there was nothing for the wire savings to
      buy and the encode/decode compute is dead weight — this is checked
      *first*, so a micro-delta on a negligible baseline never counts as
      a win or a loss;
    - ``wins``: the codec materially reduced a real t_overhead (by more
      than 1% of it);
    - ``loses``: the codec's compute outweighed its wire savings;
    - ``neutral``: nothing material changed (e.g. free codecs).
    """
    if overhead_none <= _NOTHING_TO_WIN * t_batch:
        return REGIME_PURE_OVERHEAD if codec_compute > 0.0 else REGIME_NEUTRAL
    margin = max(eps, 0.01 * overhead_none)
    if overhead_codec < overhead_none - margin:
        return REGIME_WINS
    if overhead_codec > overhead_none + margin:
        return REGIME_LOSES
    return REGIME_PURE_OVERHEAD if codec_compute > 0.0 else REGIME_NEUTRAL
