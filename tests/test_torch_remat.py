"""``cfg.remat_policy == "dots"`` in the port's decoder stack
(``models/transformer.forward``): each layer under a selective checkpoint
that saves the outputs of the products without batch dims (``aten.mm``,
``aten.addmm``) and recomputes the rest, the counterpart of the reference's
``jax.checkpoint(..., policy=dots_with_no_batch_dims_saveable)``.

The smoke dense (stablelm-3b) and MoE (moonshot-v1-16b-a3b: a leading dense
layer, a shared expert) decoders in float32, with JAX's parameters
(``params_from_jax``) and the same seeded batch: the loss, the auxiliary
losses and every gradient leaf under "dots" equal JAX's under "dots" within
the families' tolerance, and equal the port's own "full" run exactly (the
saved products are the same values the recompute would make).  On one
device (``utils/step_analysis.analyze`` over plain tensors) "dots" leaves
out exactly the recompute of the projections: 2 N_p T FLOPs, N_p the
parameters of the layers' products that "full" recomputes."""
import jax
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.models.registry import get_model as jmodel
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel
from repro_torch.parallel import sharding as shd
from repro_torch.utils.step_analysis import analyze
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

# f32 end to end; the families' tolerance (tests/test_torch_families.py)
TOL = dict(rtol=2e-4, atol=2e-4)


def _runs(arch):
    cj = jget(arch).smoke().replace(remat=True, remat_policy="dots")
    ct = tget(arch).smoke().replace(remat=True, remat_policy="dots")
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct, "cpu")
    batch = SyntheticLM(ct, INPUT_SHAPES["train_4k"].smoke(), seed=3).batch(0)
    return api_j, api_t, params_j, params_t, batch


@pytest.mark.parametrize("arch", ["stablelm-3b", "moonshot-v1-16b-a3b"])
def test_dots_gives_the_losses_and_gradients_of_jax_and_of_full(arch):
    api_j, api_t, params_j, params_t, batch = _runs(arch)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(api_j.loss_fn, has_aux=True))(
        params_j, {k: to_jax(v) for k, v in batch.items()})
    bt = {k: to_torch(v) for k, v in batch.items()}
    (loss_t, met_t), grads_t = value_and_grad(api_t.loss_fn, params_t, bt)
    full = tmodel(api_t.cfg.replace(remat_policy="full"))
    (loss_f, met_f), grads_f = value_and_grad(full.loss_fn, params_t, bt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    np.testing.assert_allclose(float(met_t["aux"]), float(met_j["aux"]), **TOL)
    assert (float(met_t["aux"]) > 0) == (arch == "moonshot-v1-16b-a3b")
    assert float(loss_t) == float(loss_f) and float(met_t["aux"]) == float(met_f["aux"])
    for path, gj, gt, gf in zip(tree_paths(grads_t), jax.tree_util.tree_leaves(grads_j),
                                tree_leaves(grads_t), tree_leaves(grads_f)):
        np.testing.assert_allclose(np32(gt), np.asarray(gj), err_msg=path, **TOL)
        assert torch.equal(gt, gf), path


def _step_flops(cfg, params, batch) -> float:
    api = tmodel(cfg)
    return analyze(lambda p, b: value_and_grad(api.loss_fn, p, b), params, batch)[1].flops


def test_dots_leaves_out_the_recompute_of_the_projections():
    """stablelm-3b smoke on one device: "full" recomputes every product of a
    layer but its last (``torch.utils.checkpoint`` stops once it has what
    the backward needs, so the MLP's ``wo`` is not run again) and the
    attention; "dots" recomputes the attention alone.  The difference is
    2 T N_p, N_p the parameters of q, k, v, o, the MLP's ``wi`` and ``wg``
    in every layer, T the batch's tokens; "dots" still recomputes
    something (the attention's batched products)."""
    _, api_t, _, params_t, batch = _runs("stablelm-3b")
    bt = {k: to_torch(v) for k, v in batch.items()}
    cfg = api_t.cfg
    dots = _step_flops(cfg, params_t, bt)
    full = _step_flops(cfg.replace(remat_policy="full"), params_t, bt)
    none = _step_flops(cfg.replace(remat=False), params_t, bt)
    specs = shd.param_specs(params_t, cfg)
    n_p = sum(p.numel() for path, p in zip(tree_paths(params_t), tree_leaves(params_t))
              if path.startswith("blocks.") and specs[path] and path != "blocks.mlp.wo")
    tokens = bt["tokens"].numel()
    assert full - dots == 2 * n_p * tokens
    assert none < dots < full
