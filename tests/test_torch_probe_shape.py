"""The copy probe keeps the codec kernels' launch shape.

The codec calibration (``benchmarks/torch_kernel_bench.py --calibrate``)
prices each codec stage as a number of copy-probe passes, so the probe
(``csrc/probe_copy.cu``) must stay the same kind of kernel as the quantize
kernels (``csrc/quantize.cu``): 256-element rows, one warp a row, 8 warps a
block, ceil(rows / 8) blocks.  The sources are read as text: there is no
nvcc here."""
import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
SOURCES = ("probe_copy.cu", "quantize.cu")
GRID = "(rows + WARPS_PER_CTA - 1) / WARPS_PER_CTA"
ROW_OF_WARP = "static_cast<long long>(blockIdx.x) * WARPS_PER_CTA + (threadIdx.x >> 5)"


def _text(name: str) -> str:
    """The source without its // comments."""
    return re.sub(r"//[^\n]*", "", (CSRC / name).read_text())


def _entry_point(text: str, name: str) -> str:
    """The body of ``extern "C" int <name>(...) { ... }``."""
    start = text.index(f'extern "C" int {name}(')
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("name", SOURCES)
@pytest.mark.parametrize("constant, value", [("BLOCK", 256), ("WARPS_PER_CTA", 8)])
def test_the_row_and_the_block_are_the_codec_kernels(name, constant, value):
    found = re.findall(rf"constexpr int {constant} = (\d+);", _text(name))
    assert found == [str(value)], f"{name}: {constant} = {found}"


@pytest.mark.parametrize("name", SOURCES)
def test_a_block_is_eight_warps_each_owning_a_row(name):
    text = _text(name)
    assert "constexpr int THREADS = WARPS_PER_CTA * 32;" in text
    kernels = re.findall(r"__global__ void __launch_bounds__\(THREADS\)\s*\n(\w+)\(", text)
    assert kernels, f"{name} has no kernel of THREADS threads"
    # every such kernel takes its row from its warp: one warp a row
    assert text.count(f"const long long row = {ROW_OF_WARP};") == len(kernels)


def test_the_probe_launches_a_block_for_every_eight_rows():
    body = _entry_point(_text("probe_copy.cu"), "repro_probe_copy")
    assert f"grid = static_cast<unsigned int>({GRID});" in body
    assert "probe_copy_kernel<<<grid, THREADS, 0," in body
    assert "cudaMemcpy" not in _text("probe_copy.cu")


@pytest.mark.parametrize("entry", ["repro_quantize_int8", "repro_ternarize", "repro_dequantize_int8"])
def test_the_codec_kernels_launch_the_same_grid(entry):
    text = _text("quantize.cu")
    assert f"return static_cast<unsigned int>({GRID});" in text       # grid_for
    assert re.search(r"<<<grid_for\(rows\), THREADS, 0,", _entry_point(text, entry))
