"""rwkv6-1.6b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, SSMConfig


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm", num_layers=24, d_model=2048,
        num_heads=32, num_kv_heads=32, d_ff=7168, vocab_size=65536,
        attention="none", ssm=SSMConfig(kind="rwkv6", head_dim=64),
        sharding="dp_tp", source="arXiv:2404.05892")
