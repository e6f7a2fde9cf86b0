"""stablelm-3b — MHA (kv=heads) dense decoder
[hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("stablelm-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense", num_layers=32, d_model=2560,
        num_heads=32, num_kv_heads=32, d_ff=6912, vocab_size=50304,
        sharding="dp_tp", source="hf:stabilityai/stablelm-2-1_6b")
