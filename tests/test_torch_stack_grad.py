"""How ``models/transformer.forward`` cuts a stacked layer leaf into its
layers (``_layer_views``): one ``torch.unbind`` a plain-tensor leaf a
forward, where ``p[i]`` a layer made the backward write a zero-filled
gradient of the whole leaf for every layer (``select_backward``) and add
them up.

- The loss and every gradient leaf equal, bit for bit, those of the old
  ``tree_map(lambda p: p[i], ...)`` cut: dense (stablelm-3b) and MoE with a
  leading dense stack (moonshot-v1-16b-a3b), under remat "full", "dots" and
  none.
- Under the CPU ``torch.profiler`` the backward of a 4-layer stack shows no
  ``select_backward`` of a layer's slice and no zero fill or in-place add
  of a whole stacked leaf, and one ``stack`` (under ``UnbindBackward0``) a
  stacked leaf; the old cut shows the fill and the ``select_backward`` for
  every layer of every leaf.
- The counter ``stack.unbound`` rises by the number of stacked leaves on
  every forward over plain tensors, a no-grad one and a prefill included,
  and not at all on DTensor leaves, which keep ``p[i]`` (the dry run)."""
from collections import Counter

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, open_fake_world
from repro_torch.models import transformer
from repro_torch.models.registry import get_model as tmodel
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths, value_and_grad


def _old_cut(stack, n_layers):
    return (tree_map(lambda p: p[i], stack) for i in range(n_layers))


def _setup(arch, **kw):
    cfg = tget(arch).smoke().replace(**kw)
    api = tmodel(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLM(cfg, INPUT_SHAPES["train_4k"].smoke(), seed=3).batch(0).items()}
    return api, params, batch


@pytest.mark.parametrize("remat", [None, "full", "dots"])
@pytest.mark.parametrize("arch", ["stablelm-3b", "moonshot-v1-16b-a3b"])
def test_gradients_equal_the_per_layer_select_bit_for_bit(arch, remat, monkeypatch):
    kw = dict(remat=False) if remat is None else dict(remat=True, remat_policy=remat)
    api, params, batch = _setup(arch, **kw)
    if arch == "moonshot-v1-16b-a3b":
        assert set(params) >= {"first_blocks", "blocks"}         # two stacks
    (loss, met), grads = value_and_grad(api.loss_fn, params, batch)
    monkeypatch.setattr(transformer, "_layer_views", _old_cut)
    (loss_old, met_old), grads_old = value_and_grad(api.loss_fn, params, batch)
    assert torch.equal(loss, loss_old) and torch.equal(met["aux"], met_old["aux"])
    for path, g, g_old in zip(tree_paths(grads), tree_leaves(grads), tree_leaves(grads_old)):
        assert torch.equal(g, g_old), path


def _profile_step(api, params, batch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        value_and_grad(api.loss_fn, params, batch)
    return prof.events()


def _whole_leaf_work(events, leaf_shapes):
    """(select_backward of a layer's slice, zero fills of a whole leaf,
    in-place adds of a whole leaf, stacks under ``UnbindBackward0``)."""
    whole = [list(s) for s in leaf_shapes]
    slices = [list(s[1:]) for s in leaf_shapes]
    n = Counter()
    for e in events:
        shapes = e.input_shapes
        if e.name == "aten::select_backward" and shapes[0] in slices:
            n["select_backward"] += 1
        elif e.name == "aten::zero_" and shapes[0] in whole:
            n["zero_"] += 1
        elif e.name == "aten::add_" and shapes[0] in whole:
            n["add_"] += 1
        elif (e.name == "aten::stack" and e.cpu_parent is not None
              and e.cpu_parent.name == "UnbindBackward0"):
            n["stack"] += 1
    return n


def test_the_backward_stacks_each_leaf_once_and_fills_no_whole_leaf(monkeypatch):
    api, params, batch = _setup("stablelm-3b", num_layers=4, remat=True)
    stacked = tree_leaves(params["blocks"])
    shapes = sorted({tuple(p.shape) for p in stacked})
    assert all(s[0] == 4 for s in shapes)
    n = _whole_leaf_work(_profile_step(api, params, batch), shapes)
    assert n == Counter(stack=len(stacked))
    # the old cut, through the same check: a select_backward and a whole-leaf
    # zero fill for every layer of every leaf, the adds between them
    monkeypatch.setattr(transformer, "_layer_views", _old_cut)
    n_old = _whole_leaf_work(_profile_step(api, params, batch), shapes)
    assert n_old["select_backward"] == n_old["zero_"] == 4 * len(stacked)
    assert n_old["add_"] >= 3 * len(stacked) and n_old["stack"] == 0


@pytest.mark.parametrize("arch", ["stablelm-3b", "moonshot-v1-16b-a3b"])
def test_the_counter_counts_each_stacked_leaf_on_every_forward(arch):
    api, params, batch = _setup(arch, remat=True)
    n_stacked = sum(len(tree_leaves(params[name]))
                    for name, _, _ in transformer._stacks(api.cfg))
    # attention 4, norms 2, MLP 3; an MoE layer: router and experts 4, shared expert 3
    assert n_stacked == (9 if arch == "stablelm-3b" else 9 + 13)

    def unbound():
        return trace.counts("stack")["unbound"]

    before = unbound()
    value_and_grad(api.loss_fn, params, batch)      # forward, backward with recompute
    assert unbound() == before + n_stacked
    with torch.no_grad():
        api.loss_fn(params, batch)
    assert unbound() == before + 2 * n_stacked
    api.prefill(params, {"tokens": batch["tokens"]})
    assert unbound() == before + 3 * n_stacked


@pytest.fixture
def _fake_world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dtensor_leaves_keep_the_per_layer_select(_fake_world):
    """The dry run's step on a 2x2 mesh of DTensors cuts nothing by
    ``unbind`` (DTensor's rule raises where the cut dim is sharded)."""
    open_fake_world()
    cfg = tget("stablelm-3b").smoke()
    before = trace.counts("stack")["unbound"]
    rec = dryrun.dryrun_cfg(cfg, InputShape("train", 64, 4, "train"),
                            make_mesh((2, 2), ("data", "model"), "cpu"))
    assert rec["analyzed"]["flops"] > 0
    assert trace.counts("stack")["unbound"] == before
