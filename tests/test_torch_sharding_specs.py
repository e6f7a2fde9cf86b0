"""The port's sharding rules and step specs (``parallel/sharding.py``,
``launch/specs.py``) against the JAX package's, entry for entry, for all ten
architectures at full width on both production mesh shapes.

Nothing is placed on a device: the reference's parameter trees come from
``jax.eval_shape``, the port's from its ``init`` on the meta device, and the
meshes are objects with the JAX mesh's ``axis_names`` and ``devices.shape``
(as ``tests/test_sharding_specs.py`` uses them).  A JAX ``PartitionSpec``
writes a one-axis entry ``("data",)`` as ``"data"``; the port keeps the
tuple its rules build, so both sides are compared after that one
normalisation.  Leaf order is flatten order on both sides (dict keys
sorted), and the key paths are compared too."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget
from repro.configs.archs import ALL_ARCHS as JARCHS, FULL_ATTENTION as JFULL, LONG_SKIP as JSKIP
from repro.launch import specs as jspecs
from repro.models.registry import get_model as jmodel
from repro.optim.optimizers import get_optimizer as jopt
from repro.parallel import sharding as jshd
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.archs import ALL_ARCHS, FULL_ATTENTION, LONG_SKIP
from repro_torch.launch import specs
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_paths

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MOE_ARCHS = [a for a in ALL_ARCHS if get_config(a).moe is not None]


class FakeMesh:
    """The JAX mesh's interface, no devices."""

    def __init__(self, axes: dict):
        self.axis_names = tuple(axes)
        self.devices = type("devices", (), {"shape": tuple(axes.values())})


def norm(spec) -> tuple:
    """PartitionSpec's normalisation: a one-axis tuple entry is the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def jax_specs(tree) -> list:
    return [norm(s) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def jax_paths(tree) -> list:
    return [".".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    return jax.eval_shape(jmodel(jget(arch)).init, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def port_params(arch: str):
    return get_model(get_config(arch)).init(None, device="meta")


def test_the_arch_lists_are_the_reference_lists():
    assert ALL_ARCHS == JARCHS and FULL_ATTENTION == JFULL and LONG_SKIP == JSKIP


def _strategies():
    out = [(a, s, None) for a in ALL_ARCHS for s in ("dp_tp", "fsdp_tp")]
    out += [(a, s, m) for a in MOE_ARCHS for s in ("dp_tp", "fsdp_tp")
            for m in ("edim_dmodel", "edim_dff", "dff_only")]
    return out


@pytest.mark.parametrize("arch,strategy,moe_shard", _strategies())
def test_param_specs_equal_the_reference(arch, strategy, moe_shard):
    kw = {"sharding": strategy, **({"moe_shard": moe_shard} if moe_shard else {})}
    jp, tp = jax_params(arch), port_params(arch)
    want = jax_specs(jshd.param_specs(jp, jget(arch).replace(**kw)))
    got = shd.param_specs(tp, get_config(arch).replace(**kw))
    assert list(got) == tree_paths(tp) == jax_paths(jp)
    assert [norm(s) for s in got.values()] == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_opt_state_specs_equal_the_reference(arch, mesh):
    fm = FakeMesh(MESHES[mesh])
    want = jax_specs(jspecs.opt_state_specs(jax_params(arch), jget(arch), fm))
    got = specs.opt_state_specs(port_params(arch), get_config(arch), fm)
    state = specs.opt_state_shape(port_params(arch), get_optimizer("adamw"))
    assert list(got) == tree_paths(state)
    assert [norm(s) for s in got.values()] == want
    # and the optimizer state's leaves: f32 moments of the parameters' shapes
    jstate = jax.eval_shape(jopt("adamw").init, jax_params(arch))
    assert [tuple(t.shape) for t in tree_leaves(state)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jstate)]


def _cache_cases():
    return [(a, s) for a in ALL_ARCHS for s in ("decode_32k", "long_500k")
            if not (s == "long_500k" and a in LONG_SKIP)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", _cache_cases())
def test_cache_specs_equal_the_reference(arch, shape_name, mesh):
    jcfg, cfg = jget(arch), get_config(arch)
    if shape_name == "long_500k" and arch in FULL_ATTENTION:
        jcfg, cfg = jcfg.replace(sliding_window=4096), cfg.replace(sliding_window=4096)
    shape = INPUT_SHAPES[shape_name]
    fm = FakeMesh(MESHES[mesh])
    jcache = jspecs.cache_structs(jmodel(jcfg), shape.global_batch, shape.seq_len)
    want = [norm(jshd.cache_pspec(jcfg, fm, shape.global_batch, jshd._path_names(path),
                                  len(leaf.shape)))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jcache)]
    tcache = specs.cache_structs(get_model(cfg), shape.global_batch, shape.seq_len)
    got = specs.cache_shardings(cfg, fm, shape.global_batch, tcache)
    assert list(got) == jax_paths(jcache)
    assert [tuple(t.shape) for t in tree_leaves(tcache)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jcache)]
    assert [norm(s) for s in got.values()] == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ["stablelm-3b", "internvl2-2b", "whisper-base"])
def test_batch_specs_equal_the_reference(arch, shape_name, mesh):
    """The batch specs depend on the family (the VLM's prefix, Whisper's
    frames) and the shape, not on the rest of the arch."""
    fm = FakeMesh(MESHES[mesh])
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "decode":
        jb, jsp = jspecs.decode_batch_specs(jget(arch), JSHAPES[shape_name], fm)
        tb, tsp = specs.decode_batch_specs(get_config(arch), shape, fm)
    else:
        jb, jsp = jspecs.batch_specs(jget(arch), JSHAPES[shape_name], fm)
        tb, tsp = specs.batch_specs(get_config(arch), shape, fm)
    assert sorted(tsp) == sorted(jsp)
    for k in jsp:
        assert norm(tsp[k]) == norm(jsp[k]), k
        assert tuple(tb[k].shape) == tuple(jb[k].shape) and tb[k].device.type == "meta", k


def test_param_placements_written_out_by_hand():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    m = Mesh()
    assert shd.param_placements((), m) == [Replicate(), Replicate(), Replicate()]
    assert shd.param_placements((None, None, "model"), m) == [Replicate(), Replicate(), Shard(2)]
    assert shd.param_placements(("data", "model"), m) == [Replicate(), Shard(0), Shard(1)]
    assert shd.param_placements((("pod", "data"), None), m) == [Shard(0), Shard(0), Replicate()]
    assert shd.param_placements((None, ("pod", "data"), None, "model"), m) == [
        Shard(1), Shard(1), Shard(3)]
    with pytest.raises(ValueError, match="two tensor dims"):
        shd.param_placements(("model", "model"), m)


def _axis_size(axes: dict, entry) -> int:
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= axes.get(a, 1)
    return n


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_sharded_dim_divides_on_both_meshes(arch):
    cfg = get_config(arch)
    tp = port_params(arch)
    for axes in MESHES.values():
        fm = FakeMesh(axes)
        for what, tree, sp in (("params", tp, shd.param_specs(tp, cfg)),
                               ("opt", specs.opt_state_shape(tp, get_optimizer("adamw")),
                                specs.opt_state_specs(tp, cfg, fm))):
            for path, leaf in zip(tree_paths(tree), tree_leaves(tree)):
                for dim, entry in enumerate(sp[path]):
                    if entry is not None:
                        assert leaf.shape[dim] % _axis_size(axes, entry) == 0, (what, path, dim)


def test_fsdp_tp_shards_over_data_and_dp_tp_does_not():
    cfg = get_config("command-r-35b")
    assert cfg.sharding == "fsdp_tp"
    tp = port_params("command-r-35b")
    fsdp = shd.param_specs(tp, cfg)
    dp = shd.param_specs(tp, cfg.replace(sharding="dp_tp"))
    assert fsdp != dp
    assert sum("data" in s for s in fsdp.values()) > 0
    assert sum("data" in s for s in dp.values()) == 0


def test_the_batch_rule_takes_a_world_or_a_mesh():
    from repro_torch.parallel.collectives import InProcessWorld

    for size, batch in ((1, 3), (2, 4), (4, 2)):
        world = shd.data_batch_spec(InProcessWorld(size), batch)
        mesh = shd.data_batch_spec(FakeMesh({"data": size, "model": 1}), batch)
        assert world == mesh
    assert shd.batch_shardable(FakeMesh(MESHES["2x16x16"]), 128) == ("pod", "data")
    assert shd.batch_shardable(FakeMesh(MESHES["2x16x16"]), 16) == ("data",)
    assert shd.batch_shardable(FakeMesh(MESHES["2x16x16"]), 1) is None
