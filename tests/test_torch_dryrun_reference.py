"""The port's dry run (``launch/dryrun.dryrun_cfg``) held against the
reference's compiled dry run on the same combinations: train_4k on 16x16
for one architecture of each family (``test_torch_dryrun.FAMILIES``) at a
reduced depth, under ``remat_policy`` "full" and, where the reference reads
it (the decoders of ``models/transformer.py``), "dots"; stablelm-3b on
2x16x16; decode_32k for one architecture of each family and the
``fsdp_tp`` ones, long_500k for the same less Whisper (which the reference
skips) and arctic-480b, and prefill_32k for the MoE, MLA, VLM, RWKV-6,
hybrid and Whisper models and stablelm-3b.

The reference runs in a subprocess (``tests/_torch_reference_dryrun.py``:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` on import), started before this
process traces the port's steps, so that it compiles meanwhile.  Both read per device: the reference from the
partitioned HLO (``dot`` FLOPs; each collective's output elements, times its
loop trips, by the mesh axis its ``replica_groups`` span), the port from
the operations each rank issues (``utils/step_analysis``).

XLA's CPU backend carries every collective of the bf16 models in f32
(``test_xla_carries_the_bf16_collectives_in_f32``), so the port's bf16
collectives are compared by **elements**, not bytes.

What the comparison finds, each held here to the readings recorded in
``ROADMAP.md`` Queue C (jax 0.9.0, torch 2.13):

- FLOPs: the port skips the KV blocks above the causal diagonal, which the
  reference's ``_flash_core`` scans and masks; with those added back the
  dense decoder's counts agree within 1 % under both policies, on both
  meshes and at prefill, and so do the VLM's, RWKV-6's and, with the
  reference's extra passes over its decoder's scores, Whisper's
  (``AGREE``).  The MoE, MLA and hybrid models hold their recorded gap as
  a ceiling in training and prefill (the MoE dispatch differs).  Every
  decode step agrees within 1 %: at long_500k (a batch of one, whole over
  `data`) once the products that the reference runs on fewer ranks than
  the port are added back (``long_context_repeats``).
- `data` at decode and prefill: the elements agree within 10 % once each
  leaf that the two move differently is named (``data_divergence``), but
  for Jamba's prefill, which XLA lowers with whole-batch all-reduces over
  `data`: the port's reading is held as a ceiling (``DATA_CEILING``).
  XLA's `data+model` collective-permutes (its stream moved between a
  d_model split over `model` and one over `data`) have no counterpart in
  the port (``XLA_DATA_MODEL``).
- `data` and `pod`: the ZeRO-1 gathers of the updates agree element for
  element (``ZERO1_EQUAL``); the reference all-reduces the head's gradient
  once per loss chunk, the port once, and the norms' gradients on their
  d_model shard, the port whole.
- `model`: the port holds the residual stream whole over `model`
  (``sharding.constrain_rows``), the reference leaves it to XLA, which
  splits it on d_model and gathers it before the products; the ratio of
  their elements is held within 10 % of its recorded value.
"""
import json
import math
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path
from typing import Tuple

import pytest
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, open_fake_world

HELPER = Path(__file__).resolve().parent / "_torch_reference_dryrun.py"
REPO = Path(__file__).resolve().parents[1]
TIME_LIMIT = 600              # seconds for the reference's compiles (about 70 s on 8 idle cores)


def combo(arch, layers, policy="full", shape="train_4k", multi_pod=False):
    return {"arch": arch, "shape": shape, "layers": layers, "remat_policy": policy,
            "multi_pod": multi_pod}


def depth(arch: str) -> int:
    """Layers traced: 2, Jamba's one super-block of 8."""
    return 8 if arch == "jamba-v0.1-52b" else 2


DECODE_ARCHS = ("stablelm-3b", "moonshot-v1-16b-a3b", "deepseek-v2-236b", "internvl2-2b",
                "rwkv6-1.6b", "whisper-base", "jamba-v0.1-52b", "command-r-35b", "arctic-480b")
LONG_ARCHS = tuple(a for a in DECODE_ARCHS if a not in ("whisper-base", "arctic-480b"))
PREFILL_ARCHS = ("jamba-v0.1-52b", "moonshot-v1-16b-a3b", "deepseek-v2-236b", "rwkv6-1.6b",
                 "internvl2-2b", "whisper-base")

# the slowest compile first: the reference compiles them on three threads
COMBOS = ([combo("jamba-v0.1-52b", 8)]
          + [combo(a, depth(a), shape="prefill_32k") for a in PREFILL_ARCHS]
          + [combo(a, 2, p) for p in ("full", "dots")
             for a in ("stablelm-3b", "moonshot-v1-16b-a3b", "deepseek-v2-236b", "internvl2-2b")]
          + [combo("rwkv6-1.6b", 2), combo("whisper-base", 2),
             combo("stablelm-3b", 2, multi_pod=True), combo("stablelm-3b", 2, shape="prefill_32k")]
          + [combo(a, depth(a), shape="decode_32k") for a in DECODE_ARCHS]
          + [combo(a, depth(a), shape="long_500k") for a in LONG_ARCHS])
NEW_SHAPES = [c for c in COMBOS if c["shape"] != "train_4k" and not (
    c["arch"] == "stablelm-3b" and c["shape"] == "prefill_32k")]


def key(c) -> str:
    return (f"{c['arch']}/{c['shape']}/{c['layers']}/{c['remat_policy']}"
            f"{'/2x16x16' if c['multi_pod'] else ''}")


# Recorded readings (ROADMAP Queue C): per device, reference FLOPs, port
# FLOPs, and the ratio of `model`'s collective elements, reference / port.
RECORDED = {
    "jamba-v0.1-52b/train_4k/8/full": (1.4282e14, 1.2343e14, 3.877),
    "stablelm-3b/train_4k/2/full": (9.4543e12, 8.9389e12, 3.084),
    "moonshot-v1-16b-a3b/train_4k/2/full": (1.8274e13, 1.8602e13, 3.218),
    "deepseek-v2-236b/train_4k/2/full": (5.9567e13, 5.7377e13, 2.252),
    "internvl2-2b/train_4k/2/full": (9.9944e12, 9.9944e12, 1.257),
    "stablelm-3b/train_4k/2/dots": (8.4450e12, 7.9296e12, 2.750),
    "moonshot-v1-16b-a3b/train_4k/2/dots": (1.7526e13, 1.7790e13, 3.069),
    "deepseek-v2-236b/train_4k/2/dots": (5.4513e13, 5.2093e13, 2.039),
    "internvl2-2b/train_4k/2/dots": (9.1912e12, 9.1912e12, 1.124),
    "rwkv6-1.6b/train_4k/2/full": (6.9408e12, 6.9405e12, 3.437),
    "whisper-base/train_4k/2/full": (1.8652e12, 1.6247e12, 1.295),
    "stablelm-3b/train_4k/2/full/2x16x16": (4.7271e12, 4.4695e12, 3.084),
    "stablelm-3b/prefill_32k/2/full": (4.0480e12, 2.7166e12, 1.600),
    "stablelm-3b/decode_32k/2/full": (6.2325e8, 6.2325e8, 1.800),
    "moonshot-v1-16b-a3b/decode_32k/2/full": (1.2780e9, 1.2799e9, 2.814),
    "deepseek-v2-236b/decode_32k/2/full": (1.4122e10, 1.4135e10, 1.034),
    "internvl2-2b/decode_32k/2/full": (5.8406e8, 5.8406e8, 1.589),
    "rwkv6-1.6b/decode_32k/2/full": (2.4406e8, 2.4433e8, 2.184),
    "whisper-base/decode_32k/2/full": (1.0623e8, 1.0623e8, 1.166),
    "jamba-v0.1-52b/decode_32k/8/full": (1.3295e10, 1.3299e10, 0.623),
    "command-r-35b/decode_32k/2/full": (4.5802e9, 4.5802e9, 0.337),
    "arctic-480b/decode_32k/2/full": (2.8393e10, 2.8421e10, 0.337),
    "stablelm-3b/long_500k/2/full": (1.7705e7, 2.5754e6, 0.202),
    "moonshot-v1-16b-a3b/long_500k/2/full": (6.9113e7, 8.1505e6, 0.272),
    "deepseek-v2-236b/long_500k/2/full": (4.8729e7, 4.7945e7, 0.977),
    "internvl2-2b/long_500k/2/full": (2.4969e7, 2.7279e6, 1.202),
    "rwkv6-1.6b/long_500k/2/full": (2.4610e7, 2.0019e6, 0.983),
    "jamba-v0.1-52b/long_500k/8/full": (1.3912e8, 1.3909e8, 1.411),
    "command-r-35b/long_500k/2/full": (2.8443e7, 2.8443e7, 1.222),
    "jamba-v0.1-52b/prefill_32k/8/full": (8.7909e13, 4.9913e13, 4.388),
    "moonshot-v1-16b-a3b/prefill_32k/2/full": (1.1986e13, 1.1299e13, 25.901),
    "deepseek-v2-236b/prefill_32k/2/full": (4.9779e13, 3.9590e13, 11.048),
    "rwkv6-1.6b/prefill_32k/2/full": (9.1060e11, 9.1057e11, 3.766),
    "internvl2-2b/prefill_32k/2/full": (3.2724e12, 3.2724e12, 0.750),
    "whisper-base/prefill_32k/2/full": (9.4040e11, 3.9924e11, 0.947),
}
# where the port's FLOPs equal the reference's within 1 % in training and
# prefill once the causal blocks the port skips (and, for Whisper, the
# reference's extra passes over its decoder's scores) are added back; every
# decode step agrees (``agrees``)
AGREE = ("stablelm-3b", "internvl2-2b", "rwkv6-1.6b", "whisper-base")
# the port's `data` elements held as a ceiling where no leaf formula closes
# the gap: XLA lowers Jamba's prefill with all-reduces over `data` of whole
# (32, 32768, .) activations (3.43e10 elements against the port's 8.13e8)
DATA_CEILING = {"jamba-v0.1-52b/prefill_32k/8/full": 8.1252e8}
# XLA's collectives over `data` and `model` together (collective-permutes,
# and a few all-reduces, moving its stream between a d_model split over
# `model` and one over `data`): elements a device; the port has none
XLA_DATA_MODEL = {
    "deepseek-v2-236b/decode_32k/2/full": 419840, "jamba-v0.1-52b/decode_32k/8/full": 18432,
    "command-r-35b/decode_32k/2/full": 8192, "arctic-480b/decode_32k/2/full": 121856,
    "stablelm-3b/long_500k/2/full": 1440, "moonshot-v1-16b-a3b/long_500k/2/full": 1796,
    "deepseek-v2-236b/long_500k/2/full": 1152, "internvl2-2b/long_500k/2/full": 1216,
    "rwkv6-1.6b/long_500k/2/full": 1664, "jamba-v0.1-52b/long_500k/8/full": 320,
    "command-r-35b/long_500k/2/full": 768, "jamba-v0.1-52b/prefill_32k/8/full": 285212672,
    "deepseek-v2-236b/prefill_32k/2/full": 419840}
# where `data`'s all-gathers are the ZeRO-1 gathers alone, in both packages
ZERO1_EQUAL = ("stablelm-3b", "rwkv6-1.6b", "internvl2-2b", "whisper-base")


@pytest.fixture(scope="module")
def reference():
    """The reference's reading of a combination.  Its subprocess starts
    first; the port's traces run meanwhile."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.Popen([sys.executable, str(HELPER), json.dumps(COMBOS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    readings = {}
    for c in COMBOS:            # the port's traces, while the reference compiles
        port(c)

    def get(c):
        if not readings:
            out, err = proc.communicate(timeout=TIME_LIMIT)
            assert proc.returncode == 0, err[-3000:]
            readings.update({key(r): r for r in json.loads(out)})
        return readings[key(c)]
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def _close_the_fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@lru_cache(maxsize=None)
def _port(k: str) -> dict:
    c = next(c for c in COMBOS if key(c) == k)
    open_fake_world()
    cfg, _ = dryrun.resolve_cfg(c["arch"], c["shape"])
    cfg = cfg.replace(num_layers=c["layers"], remat_policy=c["remat_policy"])
    mesh = make_production_mesh(multi_pod=c["multi_pod"], device_type="cpu")
    return dryrun.dryrun_cfg(cfg, INPUT_SHAPES[c["shape"]], mesh)


def port(c) -> dict:
    return _port(key(c))


def ref_elements(r, axis, kind=None) -> float:
    kinds = r["collectives"].get(axis, {})
    return sum(v["elements"] for k, v in kinds.items() if kind in (None, k))


def port_elements(p, axis, kind=None) -> float:
    kinds = p["analyzed"]["collective_elements_by_axis"].get(axis, {})
    return sum(v for k, v in kinds.items() if kind in (None, k))


def _score_block_flops(c) -> Tuple[float, int, int]:
    """(FLOPs a device of one chunk x chunk block's scores and values, a
    head's share and a layer's; the blocks of the causal square; the blocks
    on and below its diagonal) of the decoder's self-attention; (0, 0, 0)
    where the port runs no block loop: no attention (RWKV), or a sequence
    that the chunk does not divide (the VLM's prefix ahead of the tokens:
    one query chunk, no block skipped).  The heads a device are
    ``num_heads / model``: where they do not divide `model` the port splits
    the rows over it instead, the same share."""
    cfg, _ = dryrun.resolve_cfg(c["arch"], c["shape"])
    shape = INPUT_SHAPES[c["shape"]]
    seq = shape.seq_len + cfg.prefix_embeds
    if (shape.kind == "decode" or cfg.family == "ssm" or seq % cfg.attn_chunk
            or seq <= cfg.attn_chunk):
        return 0.0, 0, 0
    ways = {"data": 16 * (2 if c["multi_pod"] else 1), "model": 16}
    nb = seq // cfg.attn_chunk
    qk = cfg.head_dim + (cfg.mla_rope_dim if cfg.attention == "mla" else 0)
    per_block = (2 * (shape.global_batch // ways["data"]) * cfg.num_heads / ways["model"]
                 * cfg.attn_chunk ** 2 * (qk + cfg.head_dim))
    return per_block, nb * nb, nb * (nb + 1) // 2


def skipped_causal_flops(c) -> float:
    """FLOPs a device of the KV blocks above the causal diagonal that the
    reference computes and the port skips: a train step runs each block
    four times (forward, its recompute, two products in backward: under
    "dots" the attention is recomputed too)."""
    per_block, square, kept = _score_block_flops(c)
    runs = 4 if INPUT_SHAPES[c["shape"]].kind == "train" else 1
    return c["layers"] * (square - kept) * per_block * runs


def whisper_extra_flops(c) -> float:
    """FLOPs a device of the more passes over the whole causal square of
    Whisper's decoder self-attention that the reference's compiled step
    runs.  XLA splits the 8 heads' head_dim over the 16 `model` ranks: in
    a train step (six score-sized products a block, the port four) its
    backward forms the scores and the weighted values once more, two
    passes; at prefill each of the two ranks that share a head forms that
    head's whole scores and half its weighted values, half a pass more."""
    per_block, square, _ = _score_block_flops(c)
    passes = {"train": 2, "prefill": 0.5}.get(INPUT_SHAPES[c["shape"]].kind, 0)
    return c["layers"] * square * per_block * passes if c["arch"] == "whisper-base" else 0.0


def moe_layers(cfg) -> int:
    """The MoE layers of ``cfg`` (its ``num_layers`` as traced)."""
    if cfg.moe is None:
        return 0
    if cfg.family == "hybrid":
        from repro_torch.models.jamba import block_layout, n_super_blocks
        return n_super_blocks(cfg) * sum(use_moe for _, use_moe in block_layout(cfg))
    return cfg.num_layers - cfg.moe.first_dense


def attention_layers(cfg) -> int:
    """The attention layers of ``cfg`` (its ``num_layers`` as traced)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        from repro_torch.models.jamba import block_layout, n_super_blocks
        return n_super_blocks(cfg) * sum(mixer == "attn" for mixer, _ in block_layout(cfg))
    return cfg.num_layers


def traced_cfg(c):
    cfg, _ = dryrun.resolve_cfg(c["arch"], c["shape"])
    return cfg.replace(num_layers=c["layers"])


def long_context_repeats(c) -> float:
    """FLOPs a device that the reference's compiled long_500k step (a batch
    of one, whole over `data`) runs on fewer ranks than the port, which
    splits every product over `data` and, where its weight is whole over
    `model`, over `model` too (``sharding.linear``): 15/16 of each such
    product as XLA runs it, where XLA's share is 16 times the port's.

    - ``dp_tp``'s head: XLA gathers the stream over `data` and multiplies
      its whole (D, V/16) shard on every `data` rank;
    - the MoE router (D, E) and MLA's latent (D, L) and rope-key (D, R)
      projections: XLA contracts the rank's d_model slice into every
      column on every `model` rank;
    - RWKV-6's channel-mix key (D, F) and value (F, D) products and its
      decay LoRA's first product (D, 64): XLA splits them over `model`
      only (the rules leave these weights whole);
    - ``dp_tp``'s expert output product (E, F, D): XLA writes all D columns
      on every `data` rank (one token: capacity 1)."""
    if c["shape"] != "long_500k":
        return 0.0
    cfg = traced_cfg(c)
    D, n = cfg.d_model, 16
    share = 2 * D / n * (n - 1) / n                # a whole-over-one-axis (D, .) product's 15/16
    extra = share * cfg.padded_vocab if cfg.sharding == "dp_tp" else 0.0
    if cfg.moe is not None:
        extra += moe_layers(cfg) * share * cfg.moe.num_experts
        if cfg.sharding == "dp_tp":
            f = cfg.moe.d_ff_expert or cfg.d_ff
            extra += moe_layers(cfg) * 2 * cfg.moe.num_experts / n * f * D * (n - 1) / n
    if cfg.attention == "mla":
        extra += cfg.num_layers * share * (cfg.mla_kv_lora + cfg.mla_rope_dim)
    if cfg.family == "ssm":
        extra += cfg.num_layers * share * (2 * cfg.d_ff + 64)
    return extra


def agrees(c) -> bool:
    """Whether the port's FLOPs equal the reference's within 1 % once the
    named divergences are added back: every decode step, and the
    ``AGREE`` architectures' training and prefill steps."""
    return c["arch"] in AGREE or INPUT_SHAPES[c["shape"]].kind == "decode"


def data_divergence(c) -> float:
    """`data` elements a device that the port's decode or prefill step moves
    beyond the reference's (negative: fewer), by leaf:

    - decode under ``fsdp_tp``: XLA gathers the head's (D, V/16) shard
      over `data`; the port gathers the step's rows instead (``x @ w``);
    - the MoE router's statistics, where the batch splits over `data`: XLA
      gathers the (B, S, E) probabilities of a layer for its load-balance
      means, the port all-reduces their two E-wide sums and the z-loss
      (``sharding.row_mean``);
    - long_500k under ``dp_tp``: the port all-reduces the head's (1, 1,
      V/16) logits over `data` (``sharding.linear``), XLA gathers the
      (1, 1, D) stream;
    - long_500k, kv heads that do not divide `model` (the cache's slots
      split over both axes): the port merges every head's (1, H, hd)
      output, running max and denominator over `data` (``_softmax_weigh``),
      XLA a sixteenth of the heads' outputs;
    - long_500k RWKV-6: the port contracts the channel mix's key product
      over `data` and all-reduces its (1, 1, F/16) output; XLA contracts
      it over `model`."""
    cfg, shape = traced_cfg(c), INPUT_SHAPES[c["shape"]]
    D, n = cfg.d_model, 16
    out = 0.0
    if shape.kind == "decode" and c["shape"] == "decode_32k" and cfg.sharding == "fsdp_tp":
        out -= D * cfg.padded_vocab / n
    if cfg.moe is not None and shape.global_batch % n == 0:
        out += moe_layers(cfg) * (2 * cfg.moe.num_experts + 1 - shape.global_batch
                                  * (1 if shape.kind == "decode" else shape.seq_len)
                                  * cfg.moe.num_experts)
    if c["shape"] == "long_500k":
        if cfg.sharding == "dp_tp":
            out += cfg.padded_vocab / n - D
        if cfg.num_kv_heads % n and cfg.family != "ssm":
            out += attention_layers(cfg) * (cfg.num_heads * cfg.head_dim * (n - 1) / n
                                            + 2 * cfg.num_heads)
        if cfg.family == "ssm":
            out += cfg.num_layers * cfg.d_ff / n
    return out


@pytest.mark.parametrize("c", COMBOS, ids=key)
def test_flops_agree_with_the_reference_or_hold_the_recorded_gap(reference, c):
    """Each side's FLOPs equal their recorded reading (drift on either side
    shows).  Every decode step, and the dense decoder's, the VLM's, RWKV's
    and Whisper's training and prefill steps, agree with the reference
    within 1 % once the causal blocks the port skips, Whisper's extra
    passes in the reference and, at long_500k, the products the reference
    runs on fewer ranks are added back; the MoE, MLA and hybrid models'
    training and prefill gap to the reference (the MoE dispatch, ROADMAP
    Queue C) may shrink, not grow."""
    r, p = reference(c)["flops"], port(c)["flops"]
    ref_flops, port_flops, _ = RECORDED[key(c)]
    assert math.isclose(r, ref_flops, rel_tol=1e-3)
    assert math.isclose(p, port_flops, rel_tol=1e-3)
    if agrees(c):
        assert math.isclose(p + skipped_causal_flops(c) + whisper_extra_flops(c)
                            + long_context_repeats(c), r, rel_tol=0.01)
    else:
        assert abs(p / r - 1) <= abs(port_flops / ref_flops - 1) + 1e-3


@pytest.mark.parametrize("arch", ["stablelm-3b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                  "internvl2-2b"])
def test_dots_saves_the_same_products_in_both(reference, arch):
    """Under "dots" each package recomputes the attention and none of the
    projections: the FLOPs that "dots" saves against "full" agree within 1 %
    for the dense decoder and the VLM; the MoE and MLA decoders hold the
    recorded ratio of the two savings (the port's expert einsums, batched
    products, are recomputed; XLA's dispatch is another program)."""
    full, dots = combo(arch, 2), combo(arch, 2, "dots")
    saved_ref = reference(full)["flops"] - reference(dots)["flops"]
    saved_port = port(full)["flops"] - port(dots)["flops"]
    (rf, pf, _), (rd, pd, _) = RECORDED[key(full)], RECORDED[key(dots)]
    assert saved_ref > 0 and saved_port > 0
    want = 1.0 if arch in ("stablelm-3b", "internvl2-2b") else (pf - pd) / (rf - rd)
    assert math.isclose(saved_port / saved_ref, want, rel_tol=0.01)


@pytest.mark.parametrize("c", COMBOS, ids=key)
def test_model_elements_hold_the_recorded_ratio(reference, c):
    """`model`: the reference's elements over the port's, within 10 % of
    the recorded ratio (the residual stream's layout: XLA's split on
    d_model against the port's rows)."""
    ratio = ref_elements(reference(c), "model") / port_elements(port(c), "model")
    assert abs(ratio / RECORDED[key(c)][2] - 1) <= 0.10


@pytest.mark.parametrize("c", [c for c in COMBOS if c["arch"] in ZERO1_EQUAL
                               and c["shape"] == "train_4k"], ids=key)
def test_data_gathers_are_the_zero1_gathers_in_both(reference, c):
    """The ZeRO-1 moments split every replicated leaf over `data`, so each
    update is gathered once over `data`: the same elements in both."""
    assert port_elements(port(c), "data", "all-gather") == ref_elements(reference(c), "data",
                                                                        "all-gather")


def test_the_reference_reduces_the_head_gradient_once_a_loss_chunk(reference):
    """`data`'s all-reduces of the dense decoder: every gradient once in
    both, but the reference all-reduces the head's gradient shard (vocab /
    16 x d_model) in each of the S / logit_chunk loss chunks, with each
    chunk's loss, where the port reduces the summed gradient and the loss
    once; and it reduces each of the 2 L + 1 norms' gradients on its d_model
    shard (D / 16: its residual stream is split on d_model), the port
    whole."""
    c = combo("stablelm-3b", 2)
    cfg = get_config("stablelm-3b")
    chunks = INPUT_SHAPES["train_4k"].seq_len // cfg.logit_chunk
    head = cfg.padded_vocab // 16 * cfg.d_model
    norms = (2 * c["layers"] + 1) * (cfg.d_model - cfg.d_model // 16)
    want = (port_elements(port(c), "data", "all-reduce") - 1 + (chunks - 1) * head + chunks
            - norms)
    assert ref_elements(reference(c), "data", "all-reduce") == want


def test_the_pod_mesh_reduces_the_same_gradients(reference):
    """2x16x16: the port all-reduces every gradient over `data`, then over
    `pod`; the reference reduces some over both axes in one all-reduce
    (`pod+data`) and the rest in two.  Over `data`, `pod` and `pod+data`
    together, the reference reduces the head's gradient once a loss chunk as
    on 16x16, and nothing else is gathered over `pod` in either."""
    c = combo("stablelm-3b", 2, multi_pod=True)
    r, p = reference(c), port(c)
    assert set(r["collectives"]) <= {"data", "model", "pod", "pod+data", "data+model"}
    assert "all-gather" not in r["collectives"].get("pod", {})
    assert "all-gather" not in p["analyzed"]["collective_elements_by_axis"].get("pod", {})
    assert port_elements(p, "data", "all-gather") == ref_elements(r, "data", "all-gather")


def test_xla_carries_the_bf16_collectives_in_f32(reference):
    """Every collective of the bf16 stablelm-3b step is f32 in the
    reference's CPU-compiled HLO, where the port's activations cross in
    bf16: a byte count would differ by 2x, so elements are compared."""
    r = reference(combo("stablelm-3b", 2))
    dtypes = {d for kinds in r["collectives"].values() for v in kinds.values()
              for d in v["dtypes"]}
    assert dtypes == {"f32"}
    p = port(combo("stablelm-3b", 2))["analyzed"]
    ratio = (p["collective_bytes_by_axis"]["model"]["all-reduce"]
             / p["collective_elements_by_axis"]["model"]["all-reduce"])
    assert 2 <= ratio < 2.001            # bf16 but for the loss's float32 statistics


@pytest.mark.parametrize("c", NEW_SHAPES, ids=key)
def test_data_elements_agree_but_for_the_named_leaves(reference, c):
    """`data` at decode and prefill: the port's elements (every kind) equal
    the reference's plus ``data_divergence``'s named leaves within 10 %;
    Jamba's prefill holds its recorded reading as a ceiling."""
    p, r = port_elements(port(c), "data"), ref_elements(reference(c), "data")
    if key(c) in DATA_CEILING:
        assert p <= DATA_CEILING[key(c)] * (1 + 1e-3) < r
    else:
        assert math.isclose(p, r + data_divergence(c), rel_tol=0.10, abs_tol=1.0)


@pytest.mark.parametrize("c", [c for c in COMBOS if c["shape"] == "long_500k"], ids=key)
def test_long_context_splits_its_products_over_data(reference, c):
    """long_500k, a batch of one whole over `data`: no `data` rank repeats
    another's products (at most the reference's FLOPs), and no weight is
    gathered over `data`: its all-gathers there are at most 1.1 times the
    reference's (none, or MLA's latent query: 4,096 elements a layer)."""
    p, r = port(c), reference(c)
    assert p["flops"] <= r["flops"] * 1.001
    assert port_elements(p, "data", "all-gather") <= 1.1 * ref_elements(r, "data", "all-gather")


@pytest.mark.parametrize("key_", list(XLA_DATA_MODEL))
def test_xla_moves_its_stream_between_data_and_model(reference, key_):
    """XLA's collectives over `data` and `model` together: their elements
    equal the recorded reading; the port's groups are each one mesh axis."""
    c = next(c for c in COMBOS if key(c) == key_)
    assert math.isclose(ref_elements(reference(c), "data+model"), XLA_DATA_MODEL[key_],
                        rel_tol=1e-3)
    assert "data+model" not in port(c)["analyzed"]["collective_elements_by_axis"]
