"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository.

Tests marked ``card`` need an NVIDIA card; each decides inside the
``card`` fixture whether to skip, never while the module is imported.
They are run on the card by ``python -m pytest portbench/tests -m card``.

``tiny_root`` is a copy of the benchmark with one more configuration,
traffic mix and cell of a size the CPU runs in seconds, added as a later
change would add them: files and entries, no code.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

TINY_CELLS = {
    "tiny-dense.train-s128x2": ("tiny-dense", {
        "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 128, "vocab_size": 500, "num_hidden_layers": 2,
        "rms_norm_eps": 1e-5, "rope_theta": 10000, "tie_word_embeddings": False,
        "torch_dtype": "float32", "port": {"attention": "mha"}}),
    "tiny-moe.train-s128x2": ("tiny-moe", {
        "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 128, "vocab_size": 500, "num_hidden_layers": 3,
        "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
        "moe_intermediate_size": 32, "first_k_dense_replace": 1, "moe_layer_freq": 1,
        "rms_norm_eps": 1e-5, "rope_theta": 50000, "tie_word_embeddings": False,
        "torch_dtype": "float32", "port": {"attention": "mha", "head_dim": 16}}),
    # a block that reference/model.py does not know, brought as data: its
    # own reference, FLOP count and program settings named in ``port``
    "tiny-mla.train-s128x2": ("tiny-mla", {
        "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 128, "vocab_size": 500, "num_hidden_layers": 3,
        "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
        "moe_intermediate_size": 32, "first_k_dense_replace": 1, "moe_layer_freq": 1,
        "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "rms_norm_eps": 1e-5, "rope_theta": 50000, "tie_word_embeddings": False,
        "torch_dtype": "float32",
        "port": {"attention": "mla", "head_dim": 16, "reference": "reference/mla.py",
                 "counts": "counts/flops_mla.py",
                 "program": {"attention": "mla", "mla_kv_lora": 32, "mla_rope_dim": 8}}}),
}
# limits of the tiny cells, set as a cell's are: between the largest that
# the program reads against the reference on the CPU (seeds 1, 2, 3 and
# 2**31 + 11 of every cell: 1.5e-7, 1.7e-5, 1.4e-4, 2.1e-7, 1.9e-6) and the
# least that the TF32 control reads (9.9e-7, 3.8e-4, 1.2e-4, 1.2e-4, 4.4e-5)
# or the half-batch fault (7.2e-4, 5.7e-2, 3.9e-2, 2.1e-2, 8.2e-3)
TINY_LIMITS = {"loss_gap": 5e-7, "grad_gap": 8e-5, "change_gap": 5e-4,
               "grad_gap_median": 5e-6, "change_gap_median": 1e-5}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def make_tiny_root(root: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/train-s4096-int8.json").read_text())
    traffic.update(seq_len=128, batch=2, why="tiny")
    (root / "portbench/traffic/train-s128x2.json").write_text(json.dumps(traffic))
    for cell, (config, sizes) in TINY_CELLS.items():
        (root / f"portbench/configs/{config}.json").write_text(json.dumps(sizes))
        (root / f"portbench/cells/{cell}.json").write_text(json.dumps(
            {"world": 1, "checked_steps": 3, "trace_steps": 2, "limits": TINY_LIMITS}))
        bench["configs"].append({"name": config, "source": "a tiny test configuration",
                                 "file": f"portbench/configs/{config}.json", "reduced": [],
                                 "why": "CPU tests"})
        bench["workloads"].append({"name": cell, "config": config, "traffic": "train-s128x2",
                                   "chips": 1, "why": "CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
