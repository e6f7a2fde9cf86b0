"""arctic-480b — 128 experts top-2 + always-on dense residual
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, MoEConfig


@register("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", num_layers=35, d_model=7168,
        num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
        moe=MoEConfig(num_experts=128, top_k=2, num_shared_experts=1,
                      d_ff_expert=4864),
        sharding="fsdp_tp", source="hf:Snowflake/snowflake-arctic-base")
