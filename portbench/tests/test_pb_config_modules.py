"""A configuration names its own reference, FLOP count and program
settings in ``port``; one that names none gets what every configuration
got before, to the bit."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from conftest import REPO, TINY_CELLS
from portbench.counts import arch, flops, flops_mla
from portbench.harness import spec, trainer, weights
from portbench.reference import model
from portbench.reference.train import follow

FILES = {p.stem: p for p in sorted((REPO / "portbench/configs").glob("*.json"))}
TINY_CONFIGS = dict(TINY_CELLS.values())
TRAFFIC = json.loads((REPO / "portbench/traffic/train-s4096-int8.json").read_text())
CPU = torch.device("cpu")

FIXTURE = '''
from portbench.reference import model

calls = []


def leaves(a):
    return model.leaves(a)


def init(path):
    return 2.0 if path == "final_norm.w" else None


def loss(params, tokens, labels, a, mm, half=False):
    return model.loss(params, tokens, labels, a, mm, half), {"rows": tokens.shape[0]}


def after_update(params, extras, a):
    calls.append(extras)
    params["final_norm.w"].add_(0.5)
'''


def _cell(a: arch.Arch) -> spec.Cell:
    return spec.Cell(name=f"{a.name}.x", chips=1, config=a.name, arch=a, traffic=TRAFFIC,
                     cell={}, end_to_end=[], per_layer=[])


def _pinned_model_config(cell):
    """``spec.model_config`` as it stood before ``port.program``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    a = cell.arch
    moe = None
    if a.moe is not None:
        m = a.moe
        moe = MoEConfig(num_experts=m.n_experts, top_k=m.top_k, num_shared_experts=m.n_shared,
                        d_ff_expert=m.d_ff_expert, every=m.every, first_dense=m.first_dense,
                        capacity_factor=m.capacity_factor, router_z_loss=m.router_z_loss,
                        load_balance_loss=m.load_balance_loss)
    return ModelConfig(
        name=cell.config, family="moe" if moe else "dense", num_layers=a.n_layers,
        d_model=a.d_model, num_heads=a.n_heads, num_kv_heads=a.n_kv_heads, d_ff=a.d_ff,
        vocab_size=a.vocab, head_dim=a.head_dim, moe=moe, rope_theta=a.rope_theta,
        norm_eps=a.norm_eps, tie_embeddings=a.tie_embeddings, logit_chunk=a.logit_chunk,
        dtype=a.dtype, remat_policy=cell.traffic["remat_policy"], source=a.source)


def _arch_of(name: str) -> arch.Arch:
    """Each file in ``portbench/configs`` by its stem, then each tiny cell's
    configuration by its name."""
    if name in FILES:
        return arch.load(FILES[name])
    return arch.from_dict(TINY_CONFIGS[name], name)


def _names_its_block(a: arch.Arch) -> bool:
    return any(role in a.port for role in ("reference", "counts", "program"))


@pytest.mark.parametrize("name", [*FILES, *TINY_CONFIGS])
def test_model_config_is_todays_for_every_configuration_file(name):
    cell = _cell(_arch_of(name))
    if not _names_its_block(cell.arch):
        assert spec.model_config(cell) == _pinned_model_config(cell)
        return
    # the pin, then the file's port.program on top: the router's under moe
    pinned = _pinned_model_config(cell)
    program = dict(cell.arch.port.get("program", {}))
    moe = program.pop("moe", None)
    if moe is not None:
        program["moe"] = dataclasses.replace(pinned.moe, **moe)
    assert spec.model_config(cell) == pinned.replace(**program)


@pytest.mark.parametrize("name", [*FILES, *TINY_CONFIGS])
def test_every_configuration_file_takes_the_default_reference_and_count(name):
    a = _arch_of(name)
    assert not hasattr(model, "init") and not hasattr(model, "after_update")
    assert not hasattr(model, "ruled_leaves")
    if not _names_its_block(a):
        assert arch.module(a, "reference") is model
        assert arch.module(a, "counts") is flops
        assert flops.step_flops(a, 1, 4096) == 3.0 * flops.forward_flops(a, 1, 4096)
        return
    # a file that names its block is held to what it names
    mods = {role: arch.module(a, role) for role in ("reference", "counts")}
    for role, default in (("reference", model), ("counts", flops)):
        if role in a.port:
            assert Path(mods[role].__file__).resolve() == (arch.HERE / a.port[role]).resolve()
        else:
            assert mods[role] is default
    assert flops.step_flops(a, 1, 4096) == 3.0 * mods["counts"].forward_flops(a, 1, 4096)
    _, _, leaves = trainer.program_leaves(_cell(a))
    expected = mods["reference"].leaves(a)
    assert leaves == sorted(expected, key=lambda ps: weights.sort_key(ps[0]))


def test_arch_carries_the_published_keys_read_only_and_stays_hashable():
    a = arch.load(REPO / "portbench/configs/moonshot-v1-16b-a3b-l4.json")
    assert a.published["kv_lora_rank"] == 512 and a.published["scoring_func"] == "sigmoid"
    assert "port" not in a.published and a.port["attention"] == "mha"
    assert hash(a) == hash(arch.load(REPO / "portbench/configs/moonshot-v1-16b-a3b-l4.json"))
    with pytest.raises(TypeError):
        a.published["kv_lora_rank"] = 256
    assert isinstance(a.published["assumed"], arch.Frozen)


def test_a_non_mha_block_needs_a_reference_of_its_own():
    cfg = json.loads(json.dumps(TINY_CELLS["tiny-mla.train-s128x2"][1]))
    assert arch.from_dict(cfg, "tiny-mla").port["reference"] == "reference/mla.py"
    del cfg["port"]["reference"]
    with pytest.raises(ValueError, match="multi-head attention only"):
        arch.from_dict(cfg, "tiny-mla")


def test_a_module_outside_portbench_is_refused():
    cfg = dict(TINY_CELLS["tiny-dense.train-s128x2"][1], port={"reference": "../run.py"})
    with pytest.raises(ValueError, match="not a module under"):
        arch.module(arch.from_dict(cfg, "tiny-dense"), "reference")


def test_program_settings_apply_and_an_unknown_name_raises():
    cfg = json.loads(json.dumps(TINY_CELLS["tiny-mla.train-s128x2"][1]))
    mc = spec.model_config(_cell(arch.from_dict(cfg, "tiny-mla")))
    assert (mc.attention, mc.mla_kv_lora, mc.mla_rope_dim) == ("mla", 32, 8)
    cfg["port"]["program"]["mla_latent"] = 32
    with pytest.raises(ValueError, match="mla_latent"):
        spec.model_config(_cell(arch.from_dict(cfg, "tiny-mla")))


def test_mla_forward_flops_at_s4096_worked_by_hand():
    # Moonlight-16B-A3B at its published widths, 1 dense layer and 4 MoE
    # layers: q D·H·(hd + R), the latent and rope key D·(L + R), the
    # up-projection L·2·H·hd, the output H·hd·D; scores at hd + R and values
    # at hd over S/2 keys; the FFN, MoE and head as flops.py counts them
    cfg = json.loads((REPO / "portbench/configs/moonshot-v1-16b-a3b-l4.json").read_text())
    cfg["num_hidden_layers"] = 5
    cfg["port"].update(attention="mla", reference="reference/mla.py",
                       counts="counts/flops_mla.py")
    a = arch.from_dict(cfg, "moonlight-l5")
    assert arch.module(a, "counts").forward_flops is not flops.forward_flops
    T, ctx = 4096, 4096 / 2
    D, H, hd, R, L, V = 2048, 16, 128, 64, 512, 163840
    attn = (2 * (D * H * (hd + R) + D * (L + R) + L * 2 * H * hd + H * hd * D) * T
            + 2 * T * ctx * H * (hd + R) + 2 * T * ctx * H * hd)
    dense = 2 * 3 * D * 11264 * T
    moe = 2 * (D * 64 + 3 * (6 + 2) * D * 1408) * T
    assert flops_mla.forward_flops(a, 1, 4096) == 5 * attn + dense + 4 * moe + 2 * D * V * T
    assert flops_mla.forward_flops(a, 1, 4096) == pytest.approx(6.5810e12, rel=1e-4)
    assert flops.step_flops(a, 1, 4096) == 3.0 * flops_mla.forward_flops(a, 1, 4096)


def _fixture_arch(home: Path) -> arch.Arch:
    (home / "reference").mkdir(parents=True)
    (home / "reference" / "fixture.py").write_text(FIXTURE)
    cfg = dict(TINY_CELLS["tiny-dense.train-s128x2"][1],
               port={"attention": "mha", "reference": "reference/fixture.py"})
    return arch.from_dict(cfg, "tiny-fixture", home)


def _batches(a: arch.Arch, n: int):
    from portbench.harness import traffic as traffic_lib

    gen = traffic_lib.for_cell(a.vocab, dict(TRAFFIC, seq_len=32, batch=2), 5)
    return [gen(i) for i in range(n)]


def test_a_reference_init_rule_sets_its_leaves_and_draws_nothing(tmp_path):
    a = _fixture_arch(tmp_path / "portbench")
    ref = arch.module(a, "reference")
    plain = weights.make(model.leaves(a), 5, CPU, torch.float32)
    ruled = weights.make(ref.leaves(a), 5, CPU, torch.float32, ref.init)
    assert torch.equal(ruled.pop("final_norm.w"), torch.full((a.d_model,), 2.0))
    plain.pop("final_norm.w")
    assert plain.keys() == ruled.keys()
    assert all(torch.equal(plain[k], ruled[k]) for k in plain)


def test_the_post_update_hook_is_called_each_step_with_the_loss_extras(tmp_path):
    a = _fixture_arch(tmp_path / "portbench")
    ref = arch.module(a, "reference")
    assert arch.module(a, "reference") is ref
    w = weights.make(ref.leaves(a), 5, CPU, torch.float32, ref.init)
    batches = _batches(a, 3)
    traffic = dict(TRAFFIC, seq_len=32, batch=2)
    readings = follow(a, w, batches, traffic, world=2)
    assert ref.calls == [[{"rows": 1}, {"rows": 1}]] * 3
    plain = follow(arch.from_dict(TINY_CELLS["tiny-dense.train-s128x2"][1], "tiny-dense"),
                   w, batches, traffic, world=2)
    assert readings.losses[0] == plain.losses[0]
    # the hook's +0.5 a step and element, beside AdamW's 3e-4
    i = readings.paths.index("final_norm.w")
    assert readings.change_norms[i] == pytest.approx(1.5 * a.d_model ** 0.5, rel=1e-2)


def test_program_moe_settings_apply_to_the_router():
    cfg = json.loads(json.dumps(TINY_CONFIGS["tiny-moe"]))
    cfg["port"]["program"] = {"moe": {"capacity_factor": 2.0, "router_z_loss": 0.0}}
    cell = _cell(arch.from_dict(cfg, "tiny-moe"))
    pinned = _pinned_model_config(cell)
    assert spec.model_config(cell) == pinned.replace(
        moe=dataclasses.replace(pinned.moe, capacity_factor=2.0, router_z_loss=0.0))


@pytest.mark.parametrize("config, moe, match", [
    ("tiny-moe", {"capacity_factor": 2.0, "scoring_func": "sigmoid"}, r"\['scoring_func'\]"),
    ("tiny-dense", {}, "without experts"),
    ("tiny-dense", {"capacity_factor": 2.0}, "without experts")])
def test_program_moe_raises_on_an_unknown_name_or_a_dense_configuration(config, moe, match):
    cfg = json.loads(json.dumps(TINY_CONFIGS[config]))
    cfg["port"]["program"] = {"moe": moe}
    with pytest.raises(ValueError, match=match):
        spec.model_config(_cell(arch.from_dict(cfg, config)))
