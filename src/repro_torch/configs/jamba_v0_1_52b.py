"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE every other layer
[arXiv:2403.19887]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
        moe=MoEConfig(num_experts=16, top_k=2, every=2, d_ff_expert=14336),
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
        hybrid_attn_period=8, hybrid_block_layers=8,
        sharding="fsdp_tp", source="arXiv:2403.19887")
