"""The frozen yardstick: the traffic, the FLOP count, the bounds and the
bucket plan, each pinned to values worked out by hand."""
import math

import pytest

from conftest import REPO
from portbench.counts import arch, bounds, buckets, flops
from portbench.harness.traffic import ZipfBatches
from portbench.reference import model

STABLELM = arch.load(REPO / "portbench/configs/stablelm-3b.json")
MOONSHOT = arch.load(REPO / "portbench/configs/moonshot-v1-16b-a3b-l4.json")


def test_zipf_first_tokens_for_one_seed():
    batch = ZipfBatches(50304, 16, 1, seed=2147483659)(0)
    assert batch["tokens"].tolist() == [[1447, 1, 0, 31, 6901, 0, 4, 3, 22681, 7, 0, 5, 2, 40314, 0, 0]]
    assert batch["labels"][0, :-1].tolist() == batch["tokens"][0, 1:].tolist()
    assert ZipfBatches(50304, 16, 1, seed=2147483659)(1)["tokens"].tolist() != batch["tokens"].tolist()


def test_forward_flops_at_s4096_worked_by_hand():
    T, ctx = 4096, 4096 / 2
    # stablelm-3b: 32 layers of 4 D^2 attention and 3 D F MLP weights, the
    # score and value products over S/2 keys, the head over 50304 columns
    D, F, H, hd, V = 2560, 6912, 32, 80, 50304
    layer = 2 * (4 * D * D + 3 * D * F) * T + 4 * T * ctx * H * hd
    assert flops.forward_flops(STABLELM, 1, 4096) == 32 * layer + 2 * D * V * T
    assert flops.forward_flops(STABLELM, 1, 4096) == pytest.approx(2.4591e13, rel=1e-4)
    # moonshot-l4: 16 heads of 128; 1 dense layer of F 11264, then 3 MoE
    # layers: the router, 6 routed and 2 shared experts of 1408
    D, H, hd, V = 2048, 16, 128, 163840
    attn = 2 * (4 * D * H * hd) * T + 4 * T * ctx * H * hd
    dense = 2 * 3 * D * 11264 * T
    moe = 2 * (D * 64 + 3 * (6 + 2) * D * 1408) * T
    assert flops.forward_flops(MOONSHOT, 1, 4096) == 4 * attn + dense + 3 * moe + 2 * D * V * T
    assert flops.forward_flops(MOONSHOT, 1, 4096) == pytest.approx(5.8444e12, rel=1e-4)


def test_bounds_against_the_kernel_table():
    # PERF.md's kernel table: flash (32, 4096, 80) bf16 causal 0.0869 ms by
    # operations, int8 encode of 2,211,840 rows 0.848 ms and a K = 1 fused
    # add of 566,231,040 elements 1.352 ms by bytes
    assert bounds.flash_bound_s(1, 32, 32, 4096, 80) * 1e3 == pytest.approx(0.0869, abs=5e-5)
    assert bounds.quantize_bound_s(2211840) * 1e3 == pytest.approx(0.848, abs=5e-4)
    assert bounds.dequantize_bound_s(2211840) == bounds.quantize_bound_s(2211840)
    assert bounds.fused_add_bound_s(1, 566231040) * 1e3 == pytest.approx(1.352, abs=5e-4)
    # float32 at the 3xTF32 rate: 4 * 32 * 4096^2 * 80 / 2 FLOPs at 165 TFLOP/s
    assert bounds.flash_bound_s(1, 32, 32, 4096, 80, "float32") == pytest.approx(
        4 * 32 * 4096 ** 2 * 80 / 2 / (495e12 / 3))


@pytest.mark.parametrize("a, n_buckets, params", [(STABLELM, 11, 2795.9e6), (MOONSHOT, 14, 2520.7e6)],
                         ids=["stablelm-3b", "moonshot-l4"])
def test_bucket_plan_and_parameters(a, n_buckets, params):
    # the bucket counts chip_smoke.py's trainer phases count launches by
    ordered = sorted(model.leaves(a), key=lambda ps: tuple(ps[0].split(".")))
    sizes = [math.prod(shape) for _, shape in ordered]
    assert len(buckets.plan(sizes, 2)) == n_buckets
    assert sum(sizes) == pytest.approx(params, rel=1e-4)
    assert sum(n for n, _ in buckets.bucket_elements(sizes, 2)) == sum(sizes)
    assert all(rows * 256 % buckets.PAD_UNIT == 0 for _, rows in buckets.bucket_elements(sizes, 2))
