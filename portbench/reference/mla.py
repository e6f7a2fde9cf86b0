"""Plain float32 reference of a decoder whose attention is multi-head latent
attention (MLA; DeepSeek-V2 §2.1, arXiv:2405.04434) with no query
compression (``q_lora_rank`` null): a configuration names it in
``port.reference``.

Its widths are the configuration's published keys: the latent
``kv_lora_rank`` L, the rope part ``qk_rope_head_dim`` R, the per-head
``qk_nope_head_dim`` and ``v_head_dim``.  For one layer, h the normalised
input (B, S, D):

- c = RMSNorm(h · W_dkv), the latent (B, S, L), with its own scale;
- k = [c · W_uk, RoPE(h · W_kr)]: a nope part a head, and one rope key of R
  dims shared by every head;
- v = c · W_uv;
- q = h · W_q, each head's hd_nope + R split into a nope part and a rope
  part, RoPE on the latter;
- causal softmax attention at 1/sqrt(hd_nope + R), then the output
  projection W_o from H · v_head_dim.

Everything else (RMSNorm, the MLP, the MoE layer, the head and the loss,
the checkpointing) is ``reference/model.py``'s.  Plain PyTorch only: it
imports nothing of the program.

Where it follows the program rather than a published detail:

- the parameter layout is the program's (``attn.{w_q, w_dkv, w_kr, w_uk,
  w_uv, w_o, ln_kv}``): the published ``kv_a_proj_with_mqa`` (D -> L + R)
  is split into ``w_dkv`` and ``w_kr``, and ``kv_b_proj`` (L -> H ·
  (nope + v), a head's nope and v columns side by side) into ``w_uk`` and
  ``w_uv``.  The same function, other matrices;
- RoPE rotates interleaved pairs (2i, 2i + 1) of the rope part in place, at
  theta^(-2i/R).  The published code gathers the same pairs into halves
  before it rotates them, in q and in k alike, which leaves every score as
  it is;
- the latent's RMSNorm takes ``rms_norm_eps``; the published code builds it
  with its RMSNorm's default eps of 1e-6;
- the MoE layer is ``model.moe``'s softmax router with capacity, as the
  configuration's ``assumed`` says the program runs it, not a published
  sigmoid router with a correction bias.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from portbench.counts.arch import Arch
from portbench.counts.flops_mla import widths
from portbench.reference import model
from portbench.reference.model import Products, attention, rms_norm, rope


def attn_leaves(a: Arch, stack: str, n: int) -> List[Tuple[str, tuple]]:
    """MLA's leaves of a stack of ``n`` layers, in the program's layout."""
    D, H = a.d_model, a.n_heads
    L, R, nope, v = widths(a)
    return [(f"{stack}.attn.w_q", (n, D, H * (nope + R))), (f"{stack}.attn.w_dkv", (n, D, L)),
            (f"{stack}.attn.w_kr", (n, D, R)), (f"{stack}.attn.w_uk", (n, L, H * nope)),
            (f"{stack}.attn.w_uv", (n, L, H * v)), (f"{stack}.attn.w_o", (n, H * v, D)),
            (f"{stack}.attn.ln_kv", (n, L))]


def leaves(a: Arch) -> List[Tuple[str, tuple]]:
    """[(dotted path, shape)] of every parameter, layers stacked in front."""
    return model.leaves(a, attn_leaves)


def init(path: str) -> Optional[float]:
    """The latent norm's scale is ones, as every norm's; the rest takes
    ``weights.std_of``'s rule."""
    return 1.0 if path.endswith(".attn.ln_kv") else None


def mla(h, p: Dict[str, torch.Tensor], a: Arch, mm: Products):
    """The attention sublayer of one layer: (B, S, D) normalised -> (B, S, D)."""
    B, S, _ = h.shape
    H = a.n_heads
    _, R, nope, v_dim = widths(a)
    q = mm(h, p["attn.w_q"]).reshape(B, S, H, nope + R).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], a.rope_theta)], dim=-1)
    c = rms_norm(mm(h, p["attn.w_dkv"]), p["attn.ln_kv"], a.norm_eps)
    k_rope = rope(mm(h, p["attn.w_kr"])[:, None], a.rope_theta)           # (B, 1, S, R)
    k_nope = mm(c, p["attn.w_uk"]).reshape(B, S, H, nope).transpose(1, 2)
    v = mm(c, p["attn.w_uv"]).reshape(B, S, H, v_dim).transpose(1, 2)
    k = torch.cat([k_nope, k_rope.expand(B, H, S, R)], dim=-1)
    o = attention(q, k, v, mm)                               # scale 1/sqrt(nope + R)
    return mm(o.transpose(1, 2).reshape(B, S, H * v_dim), p["attn.w_o"])


def loss(params: Dict[str, torch.Tensor], tokens, labels, a: Arch, mm: Products,
         half: bool = False):
    """``model.loss`` with MLA as every layer's attention."""
    return model.loss(params, tokens, labels, a, mm, half, attend=mla)
