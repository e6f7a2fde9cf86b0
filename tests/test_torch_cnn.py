"""``repro_torch.models.cnn`` against ``repro.models.cnn``: the full-width
trees (shapes only, on both sides), their bucket plans, XLA's "SAME"
padding of the convolution and the pool at even and odd sizes, batch norm,
loss and every gradient leaf on converted parameters, a one-rank int8 sync
of a CNN gradient tree, and a CNN trained through ``make_train_step``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs.base import CommConfig as JComm
from repro.models import cnn as jcnn
from repro.parallel import grad_sync as jgs
from repro_torch.configs import CommConfig
from repro_torch.launch.train import make_train_step
from repro_torch.models import cnn as tcnn
from repro_torch.models.convert import cnn_params_from_jax
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedule import get_schedule
from repro_torch.parallel import grad_sync as tgs
from repro_torch.parallel.collectives import InProcessWorld
from repro_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten

# the paper's model sizes (MB) and the buckets of each at a 64 MB fusion buffer
PAPER = {"vgg16": (527, 5), "resnet50": (97, 2), "resnet101": (170, 3)}


def _jax_paths(tree):
    """Dotted key paths: ``DictKey.key`` for dicts, ``SequenceKey.idx`` for lists."""
    return [".".join(str(k.key if hasattr(k, "key") else k.idx) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", ["vgg16", "resnet50", "resnet101"])
def test_full_width_tree_and_bucket_plans_match(name):
    shapes_j = jax.eval_shape(lambda k: jcnn.get_cnn(name, k)[0], jax.random.key(0))
    tree_t, _ = tcnn.get_cnn(name, None, device="meta")
    assert tree_paths(tree_t) == _jax_paths(shapes_j)
    leaves_j = jax.tree_util.tree_leaves(shapes_j)
    assert [tuple(t.shape) for t in tree_leaves(tree_t)] == [tuple(l.shape) for l in leaves_j]
    assert all(t.dtype == torch.float32 for t in tree_leaves(tree_t))
    n = sum(int(t.numel()) for t in tree_leaves(tree_t))
    assert n == sum(int(np.prod(l.shape)) for l in leaves_j)
    mb, n_buckets = PAPER[name]
    assert abs(n * 4 / 2 ** 20 - mb) < 0.05 * mb
    for fusion_mb in (64.0, 16.0):
        pj, _ = jgs.make_plan(shapes_j, fusion_mb)
        pt, _ = tgs.make_plan(tree_t, fusion_mb)
        assert pt.shapes == [tuple(s) for s in pj.shapes]
        assert pt.bucket_sizes == pj.bucket_sizes
        assert pt.assignments == pj.assignments
        assert pt.bucket_tensors == pj.bucket_tensors
        if fusion_mb == 64.0:
            assert pt.n_buckets == n_buckets


def test_same_pads_follow_xla():
    assert tcnn._same_pads(224, 7, 2) == (2, 3)        # the ResNet stem
    assert tcnn._same_pads(112, 3, 2) == (0, 1)        # the stem's max pool
    assert tcnn._same_pads(56, 3, 2) == (0, 1)         # a first bottleneck's conv2
    assert tcnn._same_pads(56, 1, 2) == (0, 0)         # its downsample
    assert tcnn._same_pads(57, 3, 2) == (1, 1)
    assert tcnn._same_pads(7, 3, 1) == (1, 1)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv2d_matches_xla(k, stride, size):
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    x = rng.standard_normal((2, size, size + 2, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    for padding in ("SAME", "VALID"):
        if padding == "VALID" and k > size:
            continue
        want = jax.lax.conv_general_dilated(to_jax(x), to_jax(w), (stride, stride), padding,
                                            dimension_numbers=jcnn._DN)
        got = tcnn.conv2d(to_torch(x), to_torch(w), stride, padding)
        assert tuple(got.shape) == want.shape, padding
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5, atol=1e-5, err_msg=padding)


@pytest.mark.parametrize("size", [8, 9, 112])
@pytest.mark.parametrize("k,stride,padding", [(3, 2, "SAME"), (2, 2, "VALID"), (3, 1, "SAME"),
                                              (3, 2, "VALID")])
def test_max_pool_matches_reduce_window(k, stride, padding, size):
    rng = np.random.default_rng(size + k)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    want = jax.lax.reduce_window(to_jax(x), -jnp.inf, jax.lax.max, (1, k, k, 1),
                                 (1, stride, stride, 1), padding)
    got = tcnn.max_pool(to_torch(x), k, stride, padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(np32(got), np32(want))


def test_batch_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 4, 7)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(7).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    want = jcnn.batch_norm(to_jax(x), to_jax(scale), to_jax(bias))
    got = tcnn.batch_norm(to_torch(x), to_torch(scale), to_torch(bias))
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5, atol=1e-5)


def _jax_case(name, width, hw, classes, B=2, seed=0):
    params, forward = jcnn.get_cnn(name, jax.random.key(seed), num_classes=classes,
                                   width_mult=width)
    rng = np.random.default_rng(seed + 1)
    images = rng.standard_normal((B, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, classes, B).astype(np.int32)
    return params, forward, images, labels


def _grads_jax(name, width, classes, params_np, images, labels, dtype):
    _, forward = jcnn.get_cnn(name, jax.random.key(0), classes, width)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params_np)
    batch = {"images": jnp.asarray(images, dtype), "labels": to_jax(labels)}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jcnn.cnn_loss(forward, p, batch)))(params)
    return float(loss), [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(grads)]


def _grads_torch(name, width, classes, params_np, images, labels, dtype):
    params = cnn_params_from_jax(params_np, name, classes, width)
    leaves = [t.to(dtype).requires_grad_(True) for t in tree_leaves(params)]
    api = tcnn.cnn_api(tcnn.CNNConfig(name, classes, width))
    batch = {"images": to_torch(images, dtype), "labels": to_torch(labels.astype(np.int64))}
    loss, _ = api.loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.double().numpy() for g in grads], tree_paths(params)


def _leaf_errors(got, want):
    """Each leaf's max abs error over its largest magnitude."""
    return [float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
            for a, b in zip(got, want)]


@pytest.mark.parametrize("name,width,hw", [("resnet50", 0.125, 64), ("vgg16", 0.0625, 224)])
def test_loss_and_every_gradient_match_jax(name, width, hw):
    """Loss and every gradient leaf on the same parameters and batch.

    In float64 on both sides the port computes the reference's function:
    1e-9 of each leaf's largest magnitude (measured: 7e-13).  In float32 the
    target is 1e-4 of each leaf's largest magnitude.  VGG-16 meets it.
    ResNet-50 at 64x64, batch 2, does not on either side: a batch-norm
    scale's gradient is a sum that cancels, and JAX's own float32 gradient
    is 3.3e-4 from its float64 one.  There the port's float32 gradients are
    held to the float64 ones within twice JAX's own float32 error (and the
    loss to 1e-4)."""
    classes = 10
    params_j, _, images, labels = _jax_case(name, width, hw, classes)
    params_np = jax_tree_to_numpy(params_j)
    lj32, gj32 = _grads_jax(name, width, classes, params_np, images, labels, jnp.float32)
    lt32, gt32, paths = _grads_torch(name, width, classes, params_np, images, labels,
                                     torch.float32)
    with jax.enable_x64(True):
        lj64, gj64 = _grads_jax(name, width, classes, params_np, images, labels, jnp.float64)
    lt64, gt64, _ = _grads_torch(name, width, classes, params_np, images, labels, torch.float64)

    assert [g.shape for g in gt32] == [g.shape for g in gj32]
    np.testing.assert_allclose(lt64, lj64, rtol=1e-12)
    worst64 = max(zip(_leaf_errors(gt64, gj64), paths))
    assert worst64[0] <= 1e-9, worst64
    np.testing.assert_allclose(lt32, lj32, rtol=1e-4)
    worst32 = max(zip(_leaf_errors(gt32, gj32), paths))
    if name == "vgg16":
        assert worst32[0] <= 1e-4, worst32
    else:
        own = max(_leaf_errors(gj32, gj64))
        assert own > 1e-4                  # the reason for the bound below
        worst = max(zip(_leaf_errors(gt32, gj64), paths))
        assert worst[0] <= 2 * own, (worst, own)


@pytest.mark.parametrize("fusion_mb", [64.0, 0.25])
def test_one_rank_int8_sync_of_cnn_grads_equals_jax(fusion_mb):
    shapes = jax.eval_shape(lambda k: jcnn.get_cnn("vgg16", k, 10, 0.0625)[0],
                            jax.random.key(0))
    rng = np.random.default_rng(7)
    g = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    out_j = jgs.sync_grads(jax.tree_util.tree_map(to_jax, g), mesh,
                           JComm(compression="int8", fusion_buffer_mb=fusion_mb))
    gt = cnn_params_from_jax(g, "vgg16", 10, 0.0625)
    plan, _ = tgs.make_plan(gt, fusion_mb)
    assert plan.n_buckets == jgs.make_plan(shapes, fusion_mb)[0].n_buckets
    assert (plan.n_buckets == 1) == (fusion_mb == 64.0)
    out_t = tgs.sync_grads(gt, InProcessWorld(1), CommConfig(compression="int8",
                                                             fusion_buffer_mb=fusion_mb))
    for path, a, b in zip(tree_paths(out_t), tree_leaves(out_t), jax.tree_util.tree_leaves(out_j)):
        # the same arithmetic: equal codes and scales
        np.testing.assert_allclose(np32(a), np32(b), atol=1e-6, rtol=0, err_msg=path)


@pytest.mark.parametrize("compression", ["int8", "none"])
def test_cnn_trains_through_make_train_step(compression):
    """Two momentum-SGD steps of resnet50 (tiny) through the LLM trainer's
    step function: step 0's loss is ``loss_fn``'s on the initial parameters,
    and the loss falls."""
    api = tcnn.cnn_api(tcnn.CNNConfig("resnet50", 10, 0.125))
    params = api.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {"images": to_torch(rng.standard_normal((4, 32, 32, 3)).astype(np.float32)),
             "labels": torch.tensor([1, 3, 5, 7])}
    with torch.no_grad():
        loss0 = float(api.loss_fn(params, batch)[0])
    opt = get_optimizer("momentum")
    comm = CommConfig(mode="explicit", compression=compression)
    step = make_train_step(api, opt, InProcessWorld(1), comm, get_schedule("constant", 0.02, 0, 2))
    state = opt.init(params)
    losses = []
    for _ in range(2):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] == loss0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_init_draws_from_the_generator_and_builds_meta_trees():
    api = tcnn.cnn_api(tcnn.CNNConfig("vgg16", 10, 0.0625))
    a = api.init(torch.Generator().manual_seed(3))
    b = api.init(torch.Generator().manual_seed(3))
    c = api.init(torch.Generator().manual_seed(4))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    w = a["convs"][0]["w"]
    assert not torch.equal(w, c["convs"][0]["w"])
    assert float(w.abs().max()) <= 2 * (2.0 / (9 * 3)) ** 0.5 + 1e-6      # +-2 std, std sqrt(2/fan_in)
    meta = api.init(None, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    with pytest.raises(ValueError):
        tcnn.get_cnn("alexnet", None, device="meta")
