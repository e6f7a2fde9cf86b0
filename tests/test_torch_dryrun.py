"""The port's dry run (``launch/dryrun.py`` over ``launch/specs.py`` and
``utils/step_analysis.py``) on small fake meshes.

The JAX package's ``launch/dryrun.py`` and ``benchmarks/perf_lab.py`` set
``XLA_FLAGS`` (512 host devices) on their first lines, which would reach
every later JAX test of the worker that imported them, so neither is
imported here: ``resolve_cfg`` is held to the reference's arch lists and
``production_overrides`` instead.

Each mesh lies on a fake process group this process opens
(``launch/mesh.open_fake_world``);
the module closes it at the end."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.configs.archs import FULL_ATTENTION as JFULL, LONG_SKIP as JSKIP
from repro.configs.base import production_overrides as jprod
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.base import InputShape
from repro_torch.core.flops import model_flops
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh, open_fake_world
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.parallel import sharding as shd
from repro_torch.utils.step_analysis import analyze
from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten

# one architecture of each family
FAMILIES = {"dense": "stablelm-3b", "moe": "moonshot-v1-16b-a3b", "mla": "deepseek-v2-236b",
            "ssm": "rwkv6-1.6b", "hybrid": "jamba-v0.1-52b", "vlm": "internvl2-2b",
            "encdec": "whisper-base"}
B, S = 4, 64
SMOKE_SHAPES = {"train": InputShape("train", S, B, "train"),
                "prefill": InputShape("prefill", S, B, "prefill"),
                "decode": InputShape("decode", S, B, "decode")}


@pytest.fixture(scope="module", autouse=True)
def _close_the_fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_of(*shape):
    names = ("pod", "data", "model")[-len(shape):]
    open_fake_world()
    return make_mesh(shape, names, "cpu")


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_resolve_cfg_follows_the_reference_lists(arch, shape_name):
    cfg, note = dryrun.resolve_cfg(arch, shape_name)
    if shape_name == "long_500k" and arch in JSKIP:
        assert cfg is None and note.startswith("skip:")
        return
    want_window = 4096 if shape_name == "long_500k" and arch in JFULL else jget(arch).sliding_window
    assert cfg.sliding_window == want_window
    assert cfg.replace(sliding_window=0) == get_config(arch).replace(sliding_window=0)
    prod, pnote = dryrun.resolve_cfg(arch, shape_name, production=True)
    kw = jprod(jget(arch))
    assert all(getattr(prod, k) == v for k, v in kw.items())
    assert pnote.startswith("production flags: " + ",".join(sorted(kw)))


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_traces_on_a_2x2_mesh(family, kind):
    cfg = get_config(FAMILIES[family]).smoke()
    rec = dryrun.dryrun_cfg(cfg, SMOKE_SHAPES[kind], mesh_of(2, 2))
    assert rec["kind"] == kind and rec["mesh"] == "2x2" and rec["devices"] == 4
    assert rec["axes"] == ["data", "model"]
    ana, mem = rec["analyzed"], rec["memory"]
    assert ana["flops"] > 0 and ana["bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert set(ana["collective_bytes"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                            "all-to-all", "collective-permute"}
    assert sum(ana["collective_bytes"].values()) > 0
    assert set(ana["collective_bytes_by_axis"]) <= {"data", "model"}
    if kind == "train":       # parameters and moments are updated in place
        assert 0 < mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
        assert mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]


def test_the_pod_mesh_splits_the_batch_over_pod_and_data():
    mesh = mesh_of(2, 2, 2)
    cfg = get_config("stablelm-3b").smoke()
    rec = dryrun.dryrun_cfg(cfg, SMOKE_SHAPES["train"], mesh)
    assert rec["mesh"] == "2x2x2" and rec["axes"] == ["pod", "data", "model"]
    assert shd.data_batch_spec(mesh, B) == (("pod", "data"), None)
    assert "pod" in rec["analyzed"]["collective_bytes_by_axis"]     # gradients cross pods


def _matmul_params(cfg, path_ok):
    """Parameters of the matmuls whose key path passes ``path_ok``: leaves
    with a sharding rule (norms have none; the embedding is looked up)."""
    params = get_model(cfg).init(None, device="meta")
    sp = shd.param_specs(params, cfg)
    return sum(p.numel() for path, p in zip(tree_paths(params), tree_leaves(params))
               if sp[path] and path != "embed.w" and path_ok(path))


@pytest.mark.parametrize("remat", [False, True])
def test_train_flops_on_one_device_are_the_matmuls_of_the_step(remat):
    """On a (1, 1) mesh the traced FLOPs of a dense train step are, exactly:

    - 6 N T for the matmul parameters (forward, and the two products of the
      backward), T = B S tokens;
    - the attention's score and value products, 2 * 2 B H S^2 hd a layer
      forward and twice that backward, the causal blocks computed whole
      (one chunk of 64 here);
    - with ``remat`` the layers' forward once more (the head is not under
      checkpoint) but for each layer's last product, the MLP's ``wo``:
      ``torch.utils.checkpoint`` stops its recompute once it has rebuilt
      what the backward saved, and that product's output is not saved.

    ``core/flops.model_flops`` (6 N_active T, norms included, no
    attention) is below that by the attention and the remat share."""
    cfg = get_config("stablelm-3b").smoke().replace(remat=remat)
    shape = SMOKE_SHAPES["train"]
    rec = dryrun.dryrun_cfg(cfg, shape, mesh_of(1, 1))
    every = _matmul_params(cfg, lambda p: True)
    recomputed = _matmul_params(cfg, lambda p: p.startswith("blocks.") and p != "blocks.mlp.wo")
    T = B * S
    attn_fwd = 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim * cfg.num_layers
    want = 6 * every * T + 3 * attn_fwd
    if remat:
        want += 2 * recomputed * T + attn_fwd
    assert rec["flops"] == want
    ratio = rec["flops"] / model_flops(cfg, shape)
    assert (1.05 < ratio < 1.15) if not remat else (1.25 < ratio < 1.40)
    assert rec["analyzed"]["collective_bytes"] == {}          # one device: nothing to move


def test_per_device_flops_on_a_2x2_mesh_are_a_quarter():
    """Batch over `data` and heads, d_ff and vocab over `model` split the
    projections four ways (within 1.2 %).  The attention's batched products
    flatten (batch, head) into one dim split over both axes (a strided
    shard), and for some of them DTensor runs the product on an operand
    gathered over `model`: at this size they are 8 % of the step and cost it
    under 5 % more.  (At stablelm-3b's full size on 16x16 the per-device
    FLOPs do not move with this choice.)"""
    cfg = get_config("stablelm-3b").smoke()
    one = dryrun.dryrun_cfg(cfg, SMOKE_SHAPES["train"], mesh_of(1, 1))["flops"]
    four = dryrun.dryrun_cfg(cfg, SMOKE_SHAPES["train"], mesh_of(2, 2))["flops"]
    assert 1.0 <= 4 * four / one < 1.05


def _leaf_bytes(tree, keep=lambda path: True):
    return sum(t.numel() * t.element_size()
               for path, t in zip(tree_paths(tree), tree_leaves(tree)) if keep(path))


def test_dp_tp_all_reduces_the_gradients_of_the_replicated_leaves():
    """(2, 1) mesh, ``dp_tp``: every parameter is replicated over `data`, so
    every gradient, the embedding table's among them (each rank looks up its
    own rows: ``sharding.lookup``), is a partial sum all-reduced once; the
    moments are ZeRO-1 shards, so the update all-gathers each parameter's
    float32 update once.  Nothing else crosses `data`."""
    cfg = get_config("stablelm-3b").smoke().replace(sharding="dp_tp")
    rec = dryrun.dryrun_cfg(cfg, SMOKE_SHAPES["train"], mesh_of(2, 1))
    ana = rec["analyzed"]
    params = get_model(cfg).init(None, device="meta")
    assert ana["collective_bytes"]["all-reduce"] == _leaf_bytes(params)
    assert ana["collective_counts"]["all-reduce"] == len(tree_leaves(params))
    assert ana["collective_bytes"]["all-gather"] == sum(t.numel() * 4 for t in tree_leaves(params))
    assert ana["collective_counts"]["all-gather"] == len(tree_leaves(params))
    assert "reduce-scatter" not in ana["collective_bytes"]


@pytest.mark.parametrize("strategy", ["dp_tp", "fsdp_tp"])
def test_gradients_reduce_to_the_placements_of_their_parameters(strategy):
    """``specs.reduce_grads`` on ``Partial`` gradients, (2, 1) mesh: an
    all-reduce of every leaf replicated over `data` and a reduce-scatter
    (output: the shard) of every leaf the spec shards over it.  The whole
    step under ``fsdp_tp`` moves more: DTensor keeps a weight sharded over
    `data` and splits the activation along the contracting dim rather than
    gather the weight, so activations are reduce-scattered and gathered
    too; this test isolates the gradients'."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = mesh_of(2, 1)
    cfg = get_config("stablelm-3b").smoke().replace(sharding=strategy)
    meta = get_model(cfg).init(None, device="meta")
    sp = shd.param_specs(meta, cfg)
    params = specs.distribute(meta, sp, mesh)
    grads = [DTensor.from_local(torch.empty(t.shape, dtype=t.dtype, device="meta"), mesh,
                                [Partial(), Partial()], run_check=False)
             for t in tree_leaves(meta)]
    reduced, ana = analyze(specs.reduce_grads, tree_unflatten(meta, grads), params, mesh=mesh)
    sharded = lambda p: "data" in sp[p]                             # noqa: E731
    assert ana.collective_bytes.get("all-reduce", 0) == _leaf_bytes(meta, lambda p: not sharded(p))
    assert ana.collective_bytes.get("reduce-scatter", 0) == _leaf_bytes(meta, sharded) // 2
    assert all(g.placements == p.placements
               for g, p in zip(tree_leaves(reduced), tree_leaves(params)))
    if strategy == "dp_tp":
        assert "reduce-scatter" not in ana.collective_bytes


def test_fsdp_tp_holds_the_sharded_leaves_once_across_data():
    """The argument bytes a device holds: every leaf the spec shards over
    `data` at half its size on a (2, 1) mesh, the rest whole; the moments
    (ZeRO-1) at half of every leaf that has a dim 2 divides."""
    mesh = mesh_of(2, 1)
    cfg = get_config("stablelm-3b").smoke().replace(sharding="fsdp_tp")
    rec = dryrun.dryrun_cfg(cfg, SMOKE_SHAPES["train"], mesh)
    meta = get_model(cfg).init(None, device="meta")
    sp = shd.param_specs(meta, cfg)
    held = (_leaf_bytes(meta, lambda p: "data" not in sp[p])
            + _leaf_bytes(meta, lambda p: "data" in sp[p]) // 2)
    moments = 2 * sum(t.numel() * 4 // 2 for t in tree_leaves(meta))  # every leaf here has an even dim
    batch = 2 * (B // 2) * S * 4                                        # tokens and labels, int32
    assert rec["memory"]["argument_size_in_bytes"] == held + moments + 4 + batch
    assert rec["analyzed"]["collective_counts"]["reduce-scatter"] > 0


def test_decode_takes_the_cache_index_as_an_int():
    api = get_model(get_config("stablelm-3b").smoke())
    spec = specs.step_spec(api, SMOKE_SHAPES["decode"], mesh_of(1, 1))
    assert spec.kind == "decode" and spec.args[3] == S - 1 and spec.in_shardings[3] is None
    assert spec.donate_argnums == (2,)


def test_the_train_step_runs_on_plain_tensors_too():
    """``make_step_fn``'s step is the trainer's on plain tensors: no
    DTensor, no process group, the loss of ``loss_fn``."""
    cfg = get_config("stablelm-3b").smoke()
    api = get_model(cfg)
    opt = get_optimizer("adamw")
    params = api.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1)),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(2))}
    want = float(api.loss_fn(params, batch)[0])
    _, _, metrics = specs.make_step_fn(api, "train", opt)(params, opt.init(params), batch)
    assert float(metrics["loss"]) == want


def test_a_plain_leaf_among_dtensors_is_refused():
    """The step admits plain tensors as replicated only where the model
    builds them itself: a batch left undistributed raises."""
    api = get_model(get_config("stablelm-3b").smoke())
    opt = get_optimizer("adamw")
    mesh = mesh_of(2, 2)
    spec = specs.step_spec(api, SMOKE_SHAPES["train"], mesh, opt)
    params, state = (specs.distribute(a, sh, mesh)
                     for a, sh in zip(spec.args[:2], spec.in_shardings[:2]))
    with pytest.raises(TypeError, match="labels is a plain tensor among DTensors"):
        specs.make_step_fn(api, "train", opt)(params, state, spec.args[2])


def test_a_mesh_needs_an_open_process_group():
    """``make_mesh`` opens no group of its own: with none open it raises
    (only the dry run opens its fake one)."""
    code = ("from repro_torch.launch.mesh import make_production_mesh\n"
            "make_production_mesh(device_type='cpu')\n")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "no process group is open" in r.stderr
