"""``repro_torch.checkpoint.store`` against ``repro.checkpoint.store``: a
checkpoint either package writes restores into the other's tree bit for
bit, both write the same bytes for the same values, ``latest_step`` and the
shape check agree, and both launchers' ``--ckpt-dir`` write the same steps
and manifest."""
import filecmp
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jget
from repro.launch import train as jtrain
from repro.models.registry import get_model as jmodel
from repro.optim.optimizers import OptState as JOptState
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config as tget
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import get_model as tmodel
from repro_torch.optim.optimizers import OptState, get_optimizer as topt
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _bits(a) -> np.ndarray:
    """A jax array or a torch tensor as numpy, bfloat16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _trees(dtype: str, seed: int = 0):
    """The same state in both packages: smoke stablelm-3b parameters in
    ``dtype`` and an AdamW state of random moments, step count 7."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    params_j = jax.tree_util.tree_map(lambda p: p.astype(jdt),
                                      jmodel(jget("stablelm-3b").smoke()).init(jax.random.key(seed)))
    moments = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params_j)
    state_j = {"params": params_j, "opt": JOptState(jnp.asarray(7, jnp.int32), moments(), moments())}
    template = _template(tdt)
    state_t = tree_unflatten(template, [_to_torch(a) for a in jax.tree_util.tree_leaves(state_j)])
    return state_j, state_t


def _template(tdt, seed: int = 1):
    params = tmodel(tget("stablelm-3b").smoke()).init(torch.Generator().manual_seed(seed))
    params = tree_map(lambda p: p.to(tdt), params)
    return {"params": params, "opt": topt("adamw").init(params)}


def _equal_bits(got_leaves, want_leaves) -> None:
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=str(i))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path, dtype):
    state_j, _ = _trees(dtype)
    jstore.save(tmp_path, state_j, 3)
    got = tstore.restore(tmp_path, _template(DTYPES[dtype][1]))
    assert isinstance(got["opt"], OptState) and got["opt"].count.dtype == torch.int32
    _equal_bits(tree_leaves(got), jax.tree_util.tree_leaves(state_j))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path, dtype):
    state_j, state_t = _trees(dtype, seed=2)
    tstore.save(tmp_path, state_t, 5)
    template_j = jax.tree_util.tree_map(jnp.zeros_like, state_j)
    got = jstore.restore(tmp_path, template_j)
    _equal_bits(jax.tree_util.tree_leaves(got), tree_leaves(state_t))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_both_packages_write_the_same_bytes(tmp_path, dtype):
    state_j, state_t = _trees(dtype, seed=3)
    dj = jstore.save(tmp_path / "jax", state_j, 12)
    dt = tstore.save(tmp_path / "port", state_t, 12)
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dt.iterdir()) and "manifest.json" in names
    match, mismatch, errors = filecmp.cmpfiles(dj, dt, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)
    leaves = json.loads((dt / "manifest.json").read_text())["leaves"]
    assert "opt/.count" in leaves and "opt/.mu/blocks/attn/wk" in leaves and "params/embed/w" in leaves


def test_latest_step_and_the_shape_check_agree(tmp_path):
    assert tstore.latest_step(tmp_path / "none") is None is jstore.latest_step(tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        tstore.restore(tmp_path / "none", _template(torch.float32))
    state_j, state_t = _trees("float32")
    for step in (2, 10, 4):
        tstore.save(tmp_path, state_t, step)
    assert tstore.latest_step(tmp_path) == jstore.latest_step(tmp_path) == 10
    (tmp_path / "step_00000099.tmp").mkdir()           # an interrupted save is not a step
    assert tstore.latest_step(tmp_path) == 10
    # restore casts to the template's dtype, as the reference's
    got = tstore.restore(tmp_path, _template(torch.bfloat16), step=4)
    assert tree_leaves(got)[-1].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tree_leaves(got)[-1]),
                                  _bits(tree_leaves(state_t)[-1].to(torch.bfloat16)))
    wrong = _template(torch.float32)
    wrong["params"]["embed"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="params/embed/w"):
        tstore.restore(tmp_path, wrong)
    wrong_j = jax.tree_util.tree_map(jnp.zeros_like, state_j)
    wrong_j["params"]["embed"]["w"] = jnp.zeros((3, 3))
    with pytest.raises(ValueError, match="params/embed/w"):
        jstore.restore(tmp_path, wrong_j, step=10)


def test_ckpt_dir_writes_what_the_jax_launcher_writes(tmp_path):
    argv = ["--smoke", "--steps", "5", "--ckpt-every", "2"]
    ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
    steps = lambda d: sorted(p.name for p in d.iterdir())  # noqa: E731
    assert steps(tmp_path / "port") == steps(tmp_path / "jax") == ["step_00000002", "step_00000004"]
    for step in ("step_00000002", "step_00000004"):
        mt = json.loads((tmp_path / "port" / step / "manifest.json").read_text())
        mj = json.loads((tmp_path / "jax" / step / "manifest.json").read_text())
        assert mt["step"] == mj["step"]
        assert list(mt["leaves"]) == list(mj["leaves"])          # names, in flatten order
        assert mt["leaves"] == mj["leaves"]                      # files, shapes, dtypes
    cfg = tget("stablelm-3b").smoke()
    params = tmodel(cfg).init(torch.Generator().manual_seed(0))
    state = tstore.restore(tmp_path / "jax", {"params": params, "opt": topt("adamw").init(params)})
    assert int(state["opt"].count) == 5
