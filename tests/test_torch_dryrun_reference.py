"""The port's dry run (``launch/dryrun.dryrun_cfg``) held against the
reference's compiled dry run on the same combinations: train_4k on 16x16
for one architecture of each family (``test_torch_dryrun.FAMILIES``) at a
reduced depth, under ``remat_policy`` "full" and, where the reference reads
it (the decoders of ``models/transformer.py``), "dots"; stablelm-3b on
2x16x16 and at prefill_32k.

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
  reference's two extra passes over its decoder's scores, Whisper's
  (``AGREE``).  The MoE, MLA and hybrid models hold their recorded gap as
  a ceiling (the MoE dispatch differs).
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


# the slowest compile first: the reference compiles them on three threads
COMBOS = ([combo("jamba-v0.1-52b", 8)]
          + [combo(a, 2, p) for p in ("full", "dots")
             for a in ("stablelm-3b", "moonshot-v1-16b-a3b", "deepseek-v2-236b", "internvl2-2b")]
          + [combo("rwkv6-1.6b", 2), combo("whisper-base", 2),
             combo("stablelm-3b", 2, multi_pod=True), combo("stablelm-3b", 2, shape="prefill_32k")])


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
}
# where the port's FLOPs equal the reference's within 1 % once the causal
# blocks the port skips (and, for Whisper, the reference's extra passes over
# its decoder's scores) are added back
AGREE = ("stablelm-3b", "internvl2-2b", "rwkv6-1.6b", "whisper-base")
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
    if cfg.family == "ssm" or seq % cfg.attn_chunk or seq <= cfg.attn_chunk:
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
    """FLOPs a device of the two more passes over the whole causal square
    of Whisper's decoder self-attention that the reference's compiled step
    runs (six score-sized products a block, the port four): XLA splits the
    8 heads' head_dim over the 16 `model` ranks, and its backward forms
    the scores and the weighted values once more."""
    per_block, square, _ = _score_block_flops(c)
    return c["layers"] * square * per_block * 2 if c["arch"] == "whisper-base" else 0.0


@pytest.mark.parametrize("c", COMBOS, ids=key)
def test_flops_agree_with_the_reference_or_hold_the_recorded_gap(reference, c):
    """Each side's FLOPs equal their recorded reading (drift on either side
    shows).  The dense decoder, the VLM, RWKV and Whisper agree with the
    reference within 1 % once the causal blocks the port skips, and
    Whisper's extra passes in the reference, are added back; the MoE, MLA
    and hybrid models' gap to the reference (the MoE dispatch, ROADMAP
    Queue C) may shrink, not grow."""
    r, p = reference(c)["flops"], port(c)["flops"]
    ref_flops, port_flops, _ = RECORDED[key(c)]
    assert math.isclose(r, ref_flops, rel_tol=1e-3)
    assert math.isclose(p, port_flops, rel_tol=1e-3)
    if c["arch"] in AGREE:
        assert math.isclose(p + skipped_causal_flops(c) + whisper_extra_flops(c), r,
                            rel_tol=0.01)
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
