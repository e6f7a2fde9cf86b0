"""moonshot-v1-16b-a3b — Moonlight-16B-A3B: 64 routed top-6 + 2 shared
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, MoEConfig


@register("moonshot-v1-16b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", num_layers=48, d_model=2048,
        num_heads=16, num_kv_heads=16, head_dim=128, d_ff=11264,
        vocab_size=163840,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                      d_ff_expert=1408, first_dense=1),
        sharding="dp_tp", source="hf:moonshotai/Moonlight-16B-A3B")
