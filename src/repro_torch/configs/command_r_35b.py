"""command-r-35b — GQA, no-bias dense decoder
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("command-r-35b")
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense", num_layers=40, d_model=8192,
        num_heads=64, num_kv_heads=8, d_ff=22528, vocab_size=256000,
        sharding="fsdp_tp", source="hf:CohereForAI/c4ai-command-r-v01")
