"""Serving against the JAX package: ``prefill`` / ``decode_step``
logits of stablelm-3b and rwkv6-1.6b (smoke, f32) on parameters carried
over by ``params_from_jax``, the decode-equals-prefill property of
tests/test_decode_consistency.py, ``pad_cache`` and ``cache_spec``, the
greedy tokens of ``launch.serve.run``, and the port's ``ServeFrontend``
with the cases of tests/test_serve_frontend.py."""
import argparse
import functools
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models.registry import get_model as jmodel, pad_cache as jpad
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import ServeFrontend
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel, pad_cache as tpad
from repro_torch.utils.tree import tree_leaves, tree_paths

ARCHS = ["stablelm-3b", "rwkv6-1.6b"]
B, S = 2, 32
# tests/test_decode_consistency.py's tolerance: f32, the same function
# through a cache instead of one pass
TOL = dict(rtol=2e-3, atol=2e-3)


@functools.lru_cache(maxsize=None)
def _models(arch, window=0):
    cj, ct = jget(arch).smoke(), tget(arch).smoke()
    if window:
        cj, ct = cj.replace(sliding_window=window), ct.replace(sliding_window=window)
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct)
    return api_j, api_t, params_j, params_t, jax.jit(api_j.prefill), jax.jit(api_j.decode_step)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_one_decode_step_match_jax(arch):
    api_j, api_t, params_j, params_t, prefill_j, decode_j = _models(arch)
    toks = _tokens(api_t.cfg, S + 1, 1)
    logits_full_j, _ = prefill_j(params_j, {"tokens": to_jax(toks)})
    logits_j, cache_j = prefill_j(params_j, {"tokens": to_jax(toks[:, :S])})
    step_j, _ = decode_j(params_j, {"tokens": to_jax(toks[:, S:])}, jpad(cache_j, S + 1),
                         jnp.asarray(S, jnp.int32))
    with torch.inference_mode():
        logits_full_t, _ = api_t.prefill(params_t, {"tokens": to_torch(toks)})
        logits_t, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S])})
        step_t, _ = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, S:])},
                                      tpad(cache_t, S + 1), S)
    assert tuple(logits_t.shape) == logits_j.shape == (B, 1, api_t.cfg.padded_vocab)
    np.testing.assert_allclose(np32(logits_t), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(np32(logits_full_t), np.asarray(logits_full_j), **TOL)
    np.testing.assert_allclose(np32(step_t), np.asarray(step_j), **TOL)
    # decoding token S against the cache equals prefill over S + 1 tokens
    a, b = np32(logits_full_t)[:, -1], np32(step_t)[:, -1]
    np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_decode_steps_equal_prefill(arch):
    api_j, api_t, params_j, params_t, prefill_j, decode_j = _models(arch)
    toks = _tokens(api_t.cfg, S + 3, 2)
    with torch.inference_mode():
        logits_full, _ = api_t.prefill(params_t, {"tokens": to_torch(toks)})
        _, cache = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S])})
        cache = tpad(cache, S + 3)
        for i in range(3):
            logits, cache = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, S + i:S + i + 1])},
                                              cache, S + i)
    np.testing.assert_allclose(np32(logits_full)[:, -1], np32(logits)[:, -1], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_cache_and_cache_spec_match_jax(arch):
    api_j, api_t, params_j, params_t, prefill_j, _ = _models(arch)
    toks = _tokens(api_t.cfg, S, 3)
    _, cache_j = prefill_j(params_j, {"tokens": to_jax(toks)})
    with torch.inference_mode():
        _, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks)})
    for new_len in (S, S + 5):
        pj, pt = jpad(cache_j, new_len), tpad(cache_t, new_len)
        jpaths = [".".join(str(k.key) for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(pj)[0]]
        assert tree_paths(pt) == jpaths
        for path, a, b in zip(jpaths, tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            assert tuple(a.shape) == b.shape, path
            assert str(a.dtype).split(".")[-1] == str(b.dtype), path
            np.testing.assert_allclose(np32(a), np32(b), err_msg=path, **TOL)
    # only the ring-buffer leaves grow; the RWKV state leaves keep their shapes
    grown = tpad(cache_t, S + 5)
    for path, a, b in zip(tree_paths(grown), tree_leaves(grown), tree_leaves(cache_t)):
        grows = path.split(".")[-1] in ("k", "v")
        assert (a.shape[2] == S + 5 if grows else a.shape == b.shape), path
    # cache_spec: (shape, dtype) pairs at the same key paths
    flat_j = jax.tree_util.tree_leaves(api_j.cache_spec(B, S + 5),
                                       is_leaf=lambda x: isinstance(x, tuple))
    leaves_t = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        else:
            leaves_t.append(node)

    walk(api_t.cache_spec(B, S + 5))
    assert len(leaves_t) == len(flat_j)
    for (shape_t, dtype_t), (shape_j, dtype_j) in zip(leaves_t, flat_j):
        assert tuple(shape_t) == tuple(shape_j)
        assert str(dtype_t).split(".")[-1] == str(jnp.dtype(dtype_j))


def test_init_cache_is_the_spec_in_zeros():
    cfg = tget("stablelm-3b").smoke()
    cache = ttr.init_cache(cfg, 3, 10)
    assert tuple(cache["blocks"]["k"].shape) == (2, 3, 10, 2, 32)
    assert cache["blocks"]["v"].dtype == torch.float32 and not bool(cache["blocks"]["v"].any())
    assert tuple(ttr.init_cache(cfg.replace(sliding_window=4), 1, 10)["blocks"]["k"].shape)[2] == 4


def test_sliding_window_ring_buffer_wraps_like_jax():
    """With window W < S the ring buffer overwrites old slots: 20 decode
    steps past a 16-slot buffer give the logits JAX gives."""
    api_j, api_t, params_j, params_t, prefill_j, decode_j = _models("stablelm-3b", window=16)
    toks = _tokens(api_t.cfg, 40, 4)
    _, cache_j = prefill_j(params_j, {"tokens": to_jax(toks[:, :16])})
    with torch.inference_mode():
        _, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :16])})
        for i in range(20):
            tok = toks[:, 16 + i:17 + i]
            logits_j, cache_j = decode_j(params_j, {"tokens": to_jax(tok)}, cache_j,
                                         jnp.asarray(16 + i, jnp.int32))
            logits_t, cache_t = api_t.decode_step(params_t, {"tokens": to_torch(tok)}, cache_t, 16 + i)
    assert tuple(cache_t["blocks"]["k"].shape)[2] == 16
    assert bool(torch.isfinite(logits_t).all())
    np.testing.assert_allclose(np32(logits_t), np.asarray(logits_j), **TOL)


class _RecordConcat:
    """Stands in for ``jnp`` inside ``repro.launch.serve`` and keeps the
    token matrix that its ``run`` concatenates (it does not return it)."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def concatenate(self, xs, axis=0):
        out = jnp.concatenate(xs, axis=axis)
        self.seen.append(np.asarray(out))
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_run_gives_the_greedy_tokens_of_jax(arch, monkeypatch):
    """Same seed, same parameters (JAX's, carried over), same prompts: the
    port's launcher generates the tokens JAX's launcher generates."""
    flags = dict(arch=arch, smoke=True, batch=2, prompt_len=32, gen=4, seed=0)
    rec = _RecordConcat()
    monkeypatch.setattr(jserve, "jnp", rec)
    out_j = jserve.run(argparse.Namespace(**flags))
    monkeypatch.undo()
    _, _, _, params_t, _, _ = _models(arch)
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "32", "--gen", "4",
            "--device", "cpu"]
    out_t = tserve.run(tserve.build_parser().parse_args(argv), params=params_t)
    for key in ("arch", "batch", "prompt_len", "generated"):
        assert out_t[key] == out_j[key]
    for key in ("prefill_s", "decode_tok_per_s", "decode_ms_per_token"):
        assert out_t[key] > 0
    assert out_t["tokens"].shape == (2, 5) and out_t["prefill_logits"].shape == (2, 512)
    np.testing.assert_array_equal(out_t["tokens"], rec.seen[-1])


def test_serve_main_draws_its_own_params_and_keeps_long_prompts():
    out = tserve.main(["--arch", "rwkv6-1.6b", "--smoke", "--batch", "1", "--prompt-len", "80",
                       "--gen", "2", "--device", "cpu"])
    # the reference would have cut the prompt to 64 tokens
    assert out["prompt_len"] == 80 and out["tokens"].shape == (1, 3)
    assert np.isfinite(out["prefill_logits"]).all()


def test_serve_main_refuses_cuda_on_a_machine_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--smoke", "--gen", "1"])                  # cuda is the default
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--smoke", "--serve"])                      # before a listener starts


# ---------------------------------------------------------------------------
# ServeFrontend: the cases of tests/test_serve_frontend.py on the port's copy
# ---------------------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def frontend():
    def handler(payload):
        if payload.get("sleep"):
            time.sleep(float(payload["sleep"]))
        if payload.get("boom"):
            raise RuntimeError("boom")
        return {"echo": payload.get("x", 0)}

    front = ServeFrontend(handler, request_timeout=0.2, grace=2.0)
    t = threading.Thread(target=front.serve_forever, daemon=True)
    t.start()
    yield front
    if not front.draining.is_set():
        front.drain()
    t.join(5)
    assert not t.is_alive()


def test_frontend_healthz_and_run(frontend):
    assert _get(frontend.port, "/healthz") == (200, {"status": "ok"})
    assert _post(frontend.port, "/run", {"x": 42}) == (200, {"echo": 42})


def test_frontend_unknown_routes_and_bad_json(frontend):
    assert _get(frontend.port, "/nope")[0] == 404
    req = urllib.request.Request(f"http://127.0.0.1:{frontend.port}/run", data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=5)
    assert exc.value.code == 400


def test_frontend_handler_exception_is_500(frontend):
    code, body = _post(frontend.port, "/run", {"boom": True})
    assert code == 500 and "boom" in body["error"]


def test_frontend_slow_request_times_out_504(frontend):
    code, body = _post(frontend.port, "/run", {"sleep": 2.0})
    assert code == 504 and "exceeded" in body["error"]
    assert _get(frontend.port, "/healthz")[0] == 200      # still healthy


def test_frontend_drain_flips_probe_and_stops_listener(frontend):
    port = frontend.port
    done = threading.Event()
    results = {}

    def inflight():
        results["resp"] = _post(port, "/run", {"sleep": 0.1, "x": 1})
        done.set()

    threading.Thread(target=inflight, daemon=True).start()
    time.sleep(0.03)                                      # let the request reach the handler
    frontend.drain()
    assert done.wait(5) and results["resp"] == (200, {"echo": 1})
    assert frontend.draining.is_set()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=0.5)


def test_frontend_draining_rejects_new_work():
    front = ServeFrontend(lambda p: {"ok": True}, request_timeout=1.0, grace=1.0)
    t = threading.Thread(target=front.serve_forever, daemon=True)
    t.start()
    front.draining.set()
    assert _get(front.port, "/healthz") == (503, {"status": "draining"})
    assert _post(front.port, "/run", {})[0] == 503
    front.drain()
    t.join(5)
    assert not t.is_alive()
