"""A cell of ``BENCHMARK.json``, found by name, with everything that belongs
to it in files of their own:

- ``portbench/configs/<config>.json``: the model (``counts.arch``), and in
  its ``port`` the modules under ``portbench/`` of its plain reference
  (``port.reference``) and of its FLOP count (``port.counts``), and the
  program's settings for its block (``port.program``, its router's under
  ``port.program.moe``);
- ``portbench/traffic/<mix>.json``: the traffic and the training recipe;
- ``portbench/cells/<workload>.json``: ``world`` (data-parallel ranks, one
  a card; 1 if absent), the steps the reference follows, the traced steps
  and the limits of the comparison;
- ``portbench/metrics/<metric>.py``: a reader for each metric.

Adding a configuration, a mix, a cell or a metric adds files and entries,
also for a block that ``reference/model.py`` does not know; no code here
names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import Dict, List

from portbench.counts import arch as arch_lib

HERE = Path(__file__).resolve().parent.parent          # portbench/
ROOT = HERE.parent                                     # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: str
    arch: arch_lib.Arch
    traffic: dict
    cell: dict
    end_to_end: List[dict]         # the metrics this cell reports with --trace 0
    per_layer: List[dict]          # ... and with --trace 1

    @property
    def world(self) -> int:
        return int(self.cell.get("world", 1))

    @property
    def tokens_per_step(self) -> int:
        return self.traffic["batch"] * self.traffic["seq_len"]


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "portbench"
    return Cell(
        name=workload, chips=int(w["chips"]), config=w["config"],
        arch=arch_lib.load(root / config["file"], w["config"], here),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        cell=json.loads((here / "cells" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def reader(name: str, root: Path = ROOT):
    """``read(ctx) -> float | None`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def model_config(cell: Cell):
    """The program's ``ModelConfig`` for the cell's configuration file: its
    sizes, then the file's ``port.program`` keyword arguments on top, and
    ``port.program.moe``'s on top of the ``MoEConfig``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    a = cell.arch
    program = dict(a.port.get("program", {}))
    moe_kw = program.pop("moe", None)
    if moe_kw is not None and a.moe is None:
        raise ValueError(f"{cell.config}: port.program.moe on a configuration without experts")
    moe_kw = dict(moe_kw or {})
    _known(cell, "port.program", program, ModelConfig)
    _known(cell, "port.program.moe", moe_kw, MoEConfig)
    moe = None
    if a.moe is not None:
        m = a.moe
        moe = MoEConfig(num_experts=m.n_experts, top_k=m.top_k, num_shared_experts=m.n_shared,
                        d_ff_expert=m.d_ff_expert, every=m.every, first_dense=m.first_dense,
                        capacity_factor=m.capacity_factor, router_z_loss=m.router_z_loss,
                        load_balance_loss=m.load_balance_loss)
        moe = replace(moe, **moe_kw)
    cfg = ModelConfig(
        name=cell.config, family="moe" if moe else "dense", num_layers=a.n_layers,
        d_model=a.d_model, num_heads=a.n_heads, num_kv_heads=a.n_kv_heads, d_ff=a.d_ff,
        vocab_size=a.vocab, head_dim=a.head_dim, moe=moe, rope_theta=a.rope_theta,
        norm_eps=a.norm_eps, tie_embeddings=a.tie_embeddings, logit_chunk=a.logit_chunk,
        dtype=a.dtype, remat_policy=cell.traffic["remat_policy"], source=a.source)
    return cfg.replace(**program)


def _known(cell: Cell, where: str, kw: dict, cls) -> None:
    unknown = sorted(set(kw) - {f.name for f in fields(cls)})
    if unknown:
        raise ValueError(f"{cell.config}: {where} names {unknown}, which the program's "
                         f"{cls.__name__} does not have")


def limits(cell: Cell) -> Dict[str, float]:
    return {k: float(v) for k, v in cell.cell["limits"].items()}
