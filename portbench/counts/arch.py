"""The sizes of a configuration file, read once for the counts, the
reference and the harness alike.

A configuration file (``portbench/configs/<name>.json``) holds the model's
published ``config.json`` keys, with only what ``reduced`` names changed,
and a ``port`` object for what the published keys do not say about the
block the program runs: its attention, its router's capacity, and three
keys that let a configuration bring a block of its own as files:

- ``reference``: the plain reference, a module under ``portbench/``
  (default ``reference/model.py``, which knows multi-head attention only)
  with ``leaves(arch)`` and ``loss(params, tokens, labels, arch, mm,
  half)``, and optionally ``init(path)``, ``after_update(params, extras,
  arch)`` and ``ruled_leaves(arch)``, the leaves that ``after_update``
  alone moves (``harness/weights.py``, ``reference/train.py``,
  ``harness/check.py``);
- ``counts``: the model-FLOP count, a module under ``portbench/`` with
  ``forward_flops(arch, batch, seq)`` (default ``counts/flops.py``);
- ``program``: keyword arguments of the program's ``ModelConfig`` set on
  top of what ``harness/spec.model_config`` builds from the sizes, and
  under ``moe`` those of its ``MoEConfig`` (the router's settings).

``assumed`` in the same file says, in words, where that block departs from
the published one.  ``Arch`` carries the file's published keys and its
``port`` read-only, so that a module reads the keys of its own block
(``kv_lora_rank``, ``scoring_func``, ...) there.  Nothing here imports the
program.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from collections.abc import Mapping
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent.parent          # portbench/
# the module of each role of ``port`` where the file names none
DEFAULT_MODULES = {"reference": "portbench.reference.model", "counts": "portbench.counts.flops"}

# published key -> field of Arch; the first key present wins
_KEYS = {
    "d_model": ("hidden_size",),
    "n_heads": ("num_attention_heads",),
    "n_kv_heads": ("num_key_value_heads", "num_attention_heads"),
    "d_ff": ("intermediate_size",),
    "vocab": ("vocab_size",),
    "n_layers": ("num_hidden_layers",),
    "rope_theta": ("rope_theta",),
    "norm_eps": ("rms_norm_eps", "layer_norm_eps", "norm_eps"),
    "tie_embeddings": ("tie_word_embeddings",),
    "dtype": ("torch_dtype",),
}
_MOE_KEYS = {
    "n_experts": ("n_routed_experts", "num_experts"),
    "top_k": ("num_experts_per_tok",),
    "n_shared": ("n_shared_experts", "num_shared_experts"),
    "d_ff_expert": ("moe_intermediate_size",),
    "first_dense": ("first_k_dense_replace",),
    "every": ("moe_layer_freq",),
}


class Frozen(Mapping):
    """A read-only, hashable copy of a JSON object: objects inside it
    become ``Frozen`` and lists tuples."""

    def __init__(self, d: Optional[dict] = None):
        self._d = {k: _freeze(v) for k, v in (d or {}).items()}

    def __getitem__(self, key):
        return self._d[key]

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._d.items(), key=lambda kv: kv[0])))

    def __repr__(self) -> str:
        return f"Frozen({self._d!r})"


def _freeze(v):
    if isinstance(v, dict):
        return Frozen(v)
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


@dataclass(frozen=True)
class MoE:
    n_experts: int
    top_k: int
    n_shared: int
    d_ff_expert: int
    first_dense: int
    every: int = 1
    capacity_factor: float = 1.25
    load_balance_loss: float = 1e-2
    router_z_loss: float = 1e-3


@dataclass(frozen=True)
class Arch:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    n_layers: int
    rope_theta: float
    norm_eps: float
    tie_embeddings: bool
    dtype: str
    moe: Optional[MoE] = None
    logit_chunk: int = 512
    source: str = ""
    published: Frozen = Frozen()   # every key of the file but ``port``
    port: Frozen = Frozen()
    home: str = ""                 # the portbench/ that ``port``'s modules lie in; "" = this one

    @property
    def padded_vocab(self) -> int:
        """Rows of the embedding and columns of the head: the vocabulary
        rounded up to 256, the padding masked out of the loss."""
        return (self.vocab + 255) // 256 * 256

    @property
    def first_dense(self) -> int:
        return self.moe.first_dense if self.moe else 0

    def stacks(self):
        """[(name, layers, is_moe)] in the order the forward runs them."""
        head = [("first_blocks", self.first_dense, False)] if self.first_dense else []
        return head + [("blocks", self.n_layers - self.first_dense, self.moe is not None)]


def _pick(cfg: dict, keys, default=None):
    for k in keys:
        if k in cfg and cfg[k] is not None:
            return cfg[k]
    if default is None:
        raise KeyError(f"none of {keys} in the configuration")
    return default


def from_dict(cfg: dict, name: str = "", home: Optional[Path] = None) -> Arch:
    port = cfg.get("port", {})
    kw = {f: _pick(cfg, keys, port.get(f)) for f, keys in _KEYS.items()}
    moe = None
    if _pick(cfg, _MOE_KEYS["n_experts"], 0):
        m = {f: _pick(cfg, keys, port.get(f)) for f, keys in _MOE_KEYS.items()}
        for f in ("capacity_factor", "load_balance_loss", "router_z_loss"):
            if f in port:
                m[f] = port[f]
        moe = MoE(**m)
    head_dim = port.get("head_dim") or kw["d_model"] // kw["n_heads"]
    if port.get("attention", "mha") != "mha" and "reference" not in port:
        raise ValueError(f"{name}: the benchmark knows multi-head attention only, "
                         f"got {port['attention']!r} and no reference of its own")
    return Arch(name=name, head_dim=int(head_dim), moe=moe, source=cfg.get("source", ""),
                published=Frozen({k: v for k, v in cfg.items() if k != "port"}),
                port=Frozen(port), home=str(home or ""),
                d_model=int(kw["d_model"]), n_heads=int(kw["n_heads"]),
                n_kv_heads=int(kw["n_kv_heads"]), d_ff=int(kw["d_ff"]), vocab=int(kw["vocab"]),
                n_layers=int(kw["n_layers"]), rope_theta=float(kw["rope_theta"]),
                norm_eps=float(kw["norm_eps"]), tie_embeddings=bool(kw["tie_embeddings"]),
                dtype=str(kw["dtype"]))


def load(path: Path, name: str = "", home: Optional[Path] = None) -> Arch:
    return from_dict(json.loads(Path(path).read_text()), name or Path(path).stem, home)


_LOADED: Dict[Path, object] = {}


def module(a: Arch, role: str):
    """The module that ``a.port[role]`` names (``"reference"`` or
    ``"counts"``), loaded by its path under ``a.home`` once a process, so
    that every caller gets the same module object; where the file names
    none, the default module of ``DEFAULT_MODULES``, imported."""
    rel = a.port.get(role)
    if rel is None:
        return importlib.import_module(DEFAULT_MODULES[role])
    home = Path(a.home) if a.home else HERE
    path = (home / rel).resolve()
    if not rel.endswith(".py") or home.resolve() not in path.parents:
        raise ValueError(f"{a.name}: port.{role} {rel!r} is not a module under {home}")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(f"portbench_{role}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
