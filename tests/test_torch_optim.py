"""``repro_torch.optim`` against ``repro.optim``: optimizers for 5 steps on a
fixed numpy gradient sequence, the schedules and clipping."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np32, to_jax, to_torch

from repro.optim import optimizers as jo
from repro.optim import schedule as js
from repro_torch.optim import optimizers as to
from repro_torch.optim import schedule as ts
from repro_torch.utils.tree import tree_leaves, tree_map


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32),
            "blocks": {"k": (rng.standard_normal((2, 4, 3)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_five_steps(name, dtype):
    p0 = _tree(0)
    pj = jax.tree_util.tree_map(lambda a: to_jax(a, getattr(jnp, dtype)), p0)
    pt = tree_map(lambda a: to_torch(a, getattr(torch, dtype)), p0)
    oj, ot = jo.get_optimizer(name), to.get_optimizer(name)
    sj, st = oj.init(pj), ot.init(pt)
    for step in range(5):
        g = _tree(100 + step, 0.1)
        lr = 1e-2 * (step + 1)
        pj, sj = oj.update(pj, sj, jax.tree_util.tree_map(to_jax, g), lr)
        pt, st = ot.update(pt, st, tree_map(to_torch, g), lr)
    assert int(st.count) == int(sj.count) == 5
    # f32: the same f32 formulas, elementwise; pow/sqrt may differ in the
    # last bit.  bf16 parameters: f32 math rounded to bf16 every step, so a
    # last-bit difference can move a value by one bf16 step (2^-8).
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_allclose(np32(a), np32(b), **tol)
    for a, b in zip(tree_leaves(st.mu) + tree_leaves(st.nu),
                    jax.tree_util.tree_leaves(sj.mu) + jax.tree_util.tree_leaves(sj.nu)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_adamw_decays_matrices_only():
    p = {"w": torch.ones(3, 3), "b": torch.ones(3)}
    opt = to.adamw(weight_decay=0.5)
    st = opt.init(p)
    zero = tree_map(torch.zeros_like, p)
    p, st = opt.update(p, st, zero, 0.1)
    assert float(p["b"][0]) == 1.0 and float(p["w"][0, 0]) == pytest.approx(0.95)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 50, 99, 100, 250])
def test_warmup_cosine(step):
    lj, lt = js.warmup_cosine(3e-4, 5, 100), ts.warmup_cosine(3e-4, 5, 100)
    assert float(lt(step)) == pytest.approx(float(lj(step)), rel=1e-5, abs=1e-12)
    assert float(lt(torch.tensor(step, dtype=torch.int32))) == pytest.approx(float(lj(step)), rel=1e-5, abs=1e-12)


def test_constant_and_get_schedule():
    assert float(ts.get_schedule("constant", 0.5, 0, 0)(7)) == float(js.get_schedule("constant", 0.5, 0, 0)(7))
    assert float(ts.get_schedule("cosine", 0.5, 2, 10)(5)) == pytest.approx(
        float(js.get_schedule("cosine", 0.5, 2, 10)(5)), rel=1e-5)
    with pytest.raises(ValueError):
        ts.get_schedule("linear", 0.5, 2, 10)


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 1e6])
def test_clip_by_global_norm(max_norm):
    g = _tree(7)
    cj, nj = js.clip_by_global_norm(jax.tree_util.tree_map(to_jax, g), max_norm)
    ct, nt = ts.clip_by_global_norm(tree_map(to_torch, g), max_norm)
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    assert float(ts.global_norm(tree_map(to_torch, g))) == pytest.approx(float(nj), rel=1e-6)
    for a, b in zip(tree_leaves(ct), jax.tree_util.tree_leaves(cj)):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-6, atol=1e-7)
