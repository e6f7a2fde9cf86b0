"""internvl2-2b — InternViT (stubbed to patch embeddings) + InternLM2-1.8B
[arXiv:2404.16821]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92553,
        prefix_embeds=256, sharding="dp_tp", source="arXiv:2404.16821")
