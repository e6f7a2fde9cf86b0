"""The port's examples against the JAX package's: ``examples/torch_train_e2e.py``
(the ``repro-100m`` config and the trainer's losses),
``examples/torch_gradient_compression.py`` (each mode's first and last
loss) and ``examples/torch_serve_batch.py`` (the greedy tokens), on the same
seeds and the JAX side's parameters carried over (``params_from_jax``).

The JAX e2e example overwrites ``INPUT_SHAPES["train_4k"]`` process-wide;
``monkeypatch.setitem`` puts the reference's shape back after it."""
import argparse
import dataclasses
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))                                   # examples/

from examples import torch_gradient_compression as tgc  # noqa: E402
from examples import torch_serve_batch as tsb  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget  # noqa: E402
from repro.launch import serve as jserve, train as jtrain  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config as tget  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

# tests/test_torch_train.py's tolerance: from step 1 on, Adam's g / sqrt(g^2)
# turns last-bit gradient differences into relative parameter differences
LOSS_RTOL = 1e-3
_STEP = re.compile(r"step\s+(\d+) loss ([0-9.]+)")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's runs here are small: one thread keeps them from spinning
    against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _e2e():
    """The two e2e examples, imported here and not at collection: each
    registers ``repro-100m`` in its package's config registry."""
    from examples import torch_train_e2e, train_e2e
    return train_e2e, torch_train_e2e


def _carried(arch: str, seed: int = 0):
    """JAX's initial parameters of ``arch`` as the launchers draw them
    (``jax.random.key(seed)``), and the port's copy on the CPU."""
    cj = jget(arch).smoke() if arch != "repro-100m" else jget(arch)
    ct = tget(arch).smoke() if arch != "repro-100m" else tget(arch)
    params_j = jmodel(cj).init(jax.random.key(seed))
    return params_from_jax(jax_tree_to_numpy(params_j), ct, "cpu")


def test_repro_100m_is_the_reference_config_field_for_field():
    _e2e()
    cj, ct = jget("repro-100m"), tget("repro-100m")
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.num_layers, ct.d_model, ct.num_heads, ct.num_kv_heads, ct.d_ff, ct.vocab_size,
            ct.dtype, ct.attn_chunk, ct.logit_chunk) == (8, 768, 12, 4, 2048, 32000, "float32",
                                                         256, 256)


def test_train_e2e_gives_the_jax_examples_losses(tmp_path, monkeypatch, capsys):
    je2e, te2e = _e2e()
    flags = ["--steps", "3", "--seq-len", "64", "--batch", "2"]
    monkeypatch.setitem(JSHAPES, "train_4k", JSHAPES["train_4k"])      # restored after
    monkeypatch.setattr(sys, "argv", ["train_e2e.py", *flags, "--ckpt-dir", str(tmp_path / "j")])
    je2e.main()
    want = [float(m.group(2)) for m in _STEP.finditer(capsys.readouterr().out)]
    monkeypatch.undo()
    assert JSHAPES["train_4k"].seq_len == 4096 and INPUT_SHAPES["train_4k"].seq_len == 4096
    got = te2e.main([*flags, "--device", "cpu", "--ckpt-dir", str(tmp_path / "t")],
                    params=_carried("repro-100m"))
    assert len(want) == 3 and len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
    assert got["loss_decreased"] and INPUT_SHAPES["train_4k"].seq_len == 4096


def test_gradient_compression_gives_jax_first_and_last_losses():
    got = tgc.main(["--device", "cpu"], params=_carried("stablelm-3b"))
    assert tuple(got) == tgc.MODES == ("none", "fp16", "int8", "topk")
    for mode in tgc.MODES:
        # the reference example's own trainer command line
        want = jtrain.main([a for a in tgc.train_argv(mode, "cpu")
                            if a not in ("--device", "cpu")])
        np.testing.assert_allclose([got[mode]["first_loss"], got[mode]["last_loss"]],
                                   [want["first_loss"], want["last_loss"]], rtol=LOSS_RTOL)


class _RecordConcat:
    """Stands in for ``jnp`` in ``repro.launch.serve`` to keep the token
    matrix its ``run`` concatenates (it does not return it)."""

    def __init__(self):
        import jax.numpy as jnp
        self._jnp = jnp
        self.seen = []

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def concatenate(self, xs, axis=0):
        out = self._jnp.concatenate(xs, axis=axis)
        self.seen.append(np.asarray(out))
        return out


def test_serve_batch_gives_the_greedy_tokens_of_jax(monkeypatch):
    """Prompts of 32 tokens, which both launchers take whole (JAX's cuts at
    64), the same seed and JAX's parameters: the same tokens."""
    params = {arch: _carried(arch) for arch in tsb.ARCHS}
    got = tsb.main(["--device", "cpu"], params=params)
    for arch in tsb.ARCHS:
        rec = _RecordConcat()
        monkeypatch.setattr(jserve, "jnp", rec)
        argv = [a for a in tsb.serve_argv(arch, "cpu") if a not in ("--device", "cpu")]
        ns = argparse.Namespace(arch=arch, smoke=True, batch=2, prompt_len=32, gen=8, seed=0)
        assert argv == ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "32",
                        "--gen", "8"]
        jserve.run(ns)
        monkeypatch.undo()
        assert got[arch]["tokens"].shape == (2, 9)
        np.testing.assert_array_equal(got[arch]["tokens"], rec.seen[-1])
