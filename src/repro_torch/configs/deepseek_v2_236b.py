"""deepseek-v2-236b — MLA kv_lora=512; 2 shared + 160 routed top-6 experts
[arXiv:2405.04434]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, MoEConfig


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
        num_heads=128, num_kv_heads=128, head_dim=128, d_ff=12288,
        vocab_size=102400, attention="mla", mla_kv_lora=512, mla_rope_dim=64,
        moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                      d_ff_expert=1536, first_dense=1),
        sharding="fsdp_tp", source="arXiv:2405.04434")
