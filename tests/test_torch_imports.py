"""The port stands alone: it imports neither ``jax`` nor the JAX package,
and its kernels package imports (and its plain versions run) on a machine
with neither ``nvcc`` nor ``triton``."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m == "repro" or m.startswith("repro."))
print("IMPORTED", len(names))
print("BAD", bad)
"""

_PLAIN_WITHOUT_TOOLCHAIN = r"""
import shutil, sys
import torch
from repro_torch.kernels import build, ops, quantize, fused_add, flash_attn, topk_mask, wkv
x = torch.randn(3, 700)
q, s, n = ops.quantize_int8(x); t, ts, _ = ops.ternarize(x)
assert n == 2100 and q.shape == (64, 256) and t.shape == (64, 256)
assert ops.fused_add(torch.ones(4, 10)).tolist() == [4.0] * 10
quantize.quantize_int8_2d_plain(torch.randn(2, 256)); quantize.ternarize_2d_plain(torch.randn(2, 256))
fused_add.fused_add_2d_plain(torch.randn(2, 256))
o = flash_attn.flash_attention_cuda(torch.randn(2, 64, 16), torch.randn(2, 64, 16), torch.randn(2, 64, 16))
assert o.shape == (2, 64, 16)
sp = ops.topk_sparsify(x, 0.1, sample=100)
assert sp.shape == x.shape and int((sp != 0).sum()) > 0
topk_mask.topk_mask_2d_plain(torch.randn(2, 256), torch.tensor(0.5))
y, s = wkv.wkv(*(torch.randn(1, 2, 5, 8) for _ in range(4)), torch.zeros(2, 8), torch.zeros(1, 2, 8, 8))
assert y.shape == (1, 2, 5, 8) and s.shape == (1, 2, 8, 8)
from repro_torch.kernels import ssm_scan
y, h = ssm_scan.ssm_scan(torch.rand(1, 5, 16, 8), torch.randn(1, 5, 16, 8), torch.randn(1, 5, 16),
                         torch.zeros(1, 16, 8))
assert y.shape == (1, 5, 8) and h.shape == (1, 16, 8)
y, h = ssm_scan.ssm_scan_fused(torch.rand(1, 5, 8), torch.randn(1, 5, 8), torch.randn(1, 5, 16),
                               torch.randn(1, 5, 16), -torch.rand(8, 16), torch.zeros(1, 8, 16))
assert y.shape == (1, 5, 8) and h.shape == (1, 8, 16)
from repro_torch.launch import serve
from repro_torch.models import jamba, mamba, moe, rwkv
from repro_torch.configs import get_config
from repro_torch.models.registry import get_model
api = get_model(get_config("jamba-v0.1-52b").smoke())
logits, cache = api.prefill(api.init(torch.Generator().manual_seed(0)), {"tokens": torch.zeros(1, 4, dtype=torch.long)})
assert logits.shape == (1, 1, 512) and set(cache["l0"]) == {"conv", "ssm"}
q, s, n = ops.quantize_int8(x)
assert torch.equal(ops.dequantize_int8(q, s, n), ops.dequantize_int8(q, s, n, use_kernel=False))
from repro_torch.kernels import probe
assert torch.equal(probe.probe_copy_2d(q.float()), q.float())
assert build._lib is None, "the library must not be built for CPU tensors"
assert "triton" not in sys.modules
print("NVCC", shutil.which("nvcc"))
print("PLAIN_OK")
"""


_SLICE_12 = r"""
import os, sys
sys.path.insert(0, os.getcwd())                                  # benchmarks/
import torch.distributed as dist
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.parallel import sharding
from repro_torch.utils import step_analysis
from benchmarks import torch_perf_lab, torch_roofline
assert not dist.is_initialized(), "importing opened a process group"
assert "XLA_FLAGS" not in os.environ
assert step_analysis.COLLECTIVE_KINDS[0] == "all-gather" and mesh.GPUS_PER_NODE == 8
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""


def _run(code, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(l.split(" ", 1) for l in proc.stdout.strip().splitlines())
    assert int(lines["IMPORTED"]) >= 30
    assert lines["BAD"] == "[]"


def test_the_mesh_specs_dry_run_and_their_benches_import_alone():
    """Slice 12's modules and benches: no JAX, no JAX package, no process
    group and no ``XLA_FLAGS`` on import (the dry run opens its fake group
    only when it runs)."""
    proc = _run(_SLICE_12)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout


def test_kernels_import_and_plain_versions_run_without_nvcc_or_triton(tmp_path):
    # an empty PATH: no nvcc can be found even where one is installed
    proc = _run(_PLAIN_WITHOUT_TOOLCHAIN, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PLAIN_OK" in proc.stdout


def _port_files():
    return (sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "benchmarks").glob("torch_*.py"))
            + sorted((REPO / "examples").glob("torch_*.py")))


_FORBIDDEN = [re.compile(r"^\s*import\s+jax\b"), re.compile(r"^\s*from\s+jax\b"),
              re.compile(r"^\s*import\s+repro[^_\w]"), re.compile(r"^\s*import\s+repro$"),
              re.compile(r"^\s*from\s+repro\."), re.compile(r"^\s*from\s+repro\s+import\b")]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_of_the_port_imports_jax_or_the_jax_package(path):
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        for pat in _FORBIDDEN:
            assert not pat.search(line), f"{path}:{lineno}: {line.strip()}"


def test_the_grep_patterns_catch_what_they_should():
    hits = ["import jax", "from jax import numpy", "import repro.configs", "import repro",
            "from repro.kernels import ops", "from repro import configs", "    import jax.numpy as jnp"]
    misses = ["import repro_torch", "from repro_torch.kernels import ops", "# import jaxlib later",
              "from repro_torch import x"]
    for line in hits:
        assert any(p.search(line) for p in _FORBIDDEN), line
    for line in misses:
        assert not any(p.search(line) for p in _FORBIDDEN), line


def test_every_subpackage_is_a_package_and_sources_ship():
    names = {m.name for m in pkgutil.iter_modules([str(PKG)])}
    assert {"configs", "kernels", "models", "optim", "data", "parallel", "core", "launch"} <= names
    assert {p.name for p in (PKG / "kernels" / "csrc").glob("*.cu")} == {
        "quantize.cu", "fused_add.cu", "flash_attn.cu", "flash_attn_sm90.cu", "topk_mask.cu",
        "wkv.cu", "wkv_sm90.cu", "ssm_scan.cu", "ssm_scan_sm90.cu", "probe_copy.cu"}
    from repro_torch.kernels import build
    assert set(build.SOURCES) == {p.name for p in (PKG / "kernels" / "csrc").glob("*.cu")}
    assert (PKG / "launch" / "serve.py").exists() and (PKG / "models" / "rwkv.py").exists()
    for name in ("mamba.py", "moe.py", "jamba.py"):
        assert (PKG / "models" / name).exists(), name
    assert (PKG / "kernels" / "ssm_scan.py").exists() and (PKG / "configs" / "jamba_v0_1_52b.py").exists()
    assert build.launch_counts.get("ssm_scan") == 0 and "repro_ssm_scan" in build._SIGNATURES
    assert build.route_counts == {"wkv_chunked": 0, "ssm_scan_fused": 0}
    assert "repro_wkv_chunked_f32" in build._SIGNATURES and "repro_ssm_scan_fused" in build._SIGNATURES
    assert "repro_torch/kernels/_build/" in (REPO / ".gitignore").read_text()
