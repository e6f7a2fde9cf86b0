"""Aggregator for the 10 assigned architectures (one module per arch)."""
from __future__ import annotations

# importing registers each config
from repro_torch.configs import (jamba_v0_1_52b, command_r_35b, rwkv6_1_6b,          # noqa: F401
                                 internvl2_2b, stablelm_3b, whisper_base,            # noqa: F401
                                 deepseek_v2_236b, arctic_480b, deepseek_coder_33b,  # noqa: F401
                                 moonshot_v1_16b_a3b)                                # noqa: F401

ALL_ARCHS = ["jamba-v0.1-52b", "command-r-35b", "rwkv6-1.6b", "internvl2-2b",
             "stablelm-3b", "whisper-base", "deepseek-v2-236b", "arctic-480b",
             "deepseek-coder-33b", "moonshot-v1-16b-a3b"]

# archs whose attention is full/quadratic: long_500k runs the sliding-window
# variant; whisper skips long_500k.
FULL_ATTENTION = ["command-r-35b", "internvl2-2b", "stablelm-3b",
                  "deepseek-v2-236b", "arctic-480b", "deepseek-coder-33b",
                  "moonshot-v1-16b-a3b"]
LONG_SKIP = ["whisper-base"]
