"""Deterministic synthetic data pipeline."""
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, device_put_batch  # noqa: F401
