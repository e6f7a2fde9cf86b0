"""whisper-base — enc-dec; mel+conv frontend stubbed to frame embeddings
[arXiv:2212.04356]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig


@register("whisper-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec", num_layers=6, d_model=512,
        num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
        encoder_layers=6, encoder_seq=1500,
        sharding="dp_tp", source="arXiv:2212.04356")
