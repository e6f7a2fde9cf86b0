"""Aggregator for the ported architectures (one module per arch)."""
from __future__ import annotations

# importing registers each config
from repro_torch.configs import jamba_v0_1_52b, rwkv6_1_6b, stablelm_3b  # noqa: F401

ALL_ARCHS = ["stablelm-3b", "rwkv6-1.6b", "jamba-v0.1-52b"]
