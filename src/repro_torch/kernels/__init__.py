"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their wrappers and
their plain PyTorch versions.

Gradient-compression hot spots: ``quantize`` (int8 / ternary encode and
their decode), ``topk_mask`` (DGC top-k) and ``fused_add``; the attention
hot spot: ``flash_attn``; the RWKV-6 recurrence: ``wkv``; the Mamba
selective scan: ``ssm_scan``; the codec calibration's copy probe:
``probe``.  ``ops`` holds the public wrappers that handle the 1-D <->
(rows, 256) layout.  A wrapper runs its plain version for a CPU tensor and
launches its kernel for a CUDA tensor; the shared library is built lazily,
inside the CUDA branch.
"""
