"""Plain float32 reference of the decoder the benchmark's configurations
run: its parameter layout, its loss, nothing else.

It follows the block as the configuration file's ``port`` and ``assumed``
say the program runs it: RMSNorm before attention and before the MLP,
rotary embedding over every dim of a head in interleaved pairs, causal
multi-head attention, a SwiGLU MLP; in an MoE layer a softmax router, the
top-k experts by a stable sort (the lower index first among equals), their
gates renormalised to sum to one, a capacity of int(k * S * factor / E)
tokens an expert and batch row filled in (position, choice) order, the
tokens over it dropped, shared experts added, and the load-balance and
router-z losses added to the loss; a head over the vocabulary padded to
256, the padding masked out of a mean cross-entropy.  Each layer and each
block of the loss is checkpointed, so that a full-size model fits beside
its float32 weights, gradients and AdamW state.  Plain PyTorch only: it
imports nothing of the program.

It is the default reference (``port.reference``, ``counts/arch.py``).  A
reference of another block reuses its layout, MLP, MoE and loss, and gives
``leaves`` and ``loss`` an attention of its own (``reference/mla.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.counts.arch import Arch

Products = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NEG = -1e30


def mha_leaves(a: Arch, stack: str, n: int) -> List[Tuple[str, tuple]]:
    """The attention's leaves of a stack of ``n`` layers."""
    D, H, KV, hd = a.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    return [(f"{stack}.attn.wq", (n, D, H * hd)), (f"{stack}.attn.wk", (n, D, KV * hd)),
            (f"{stack}.attn.wv", (n, D, KV * hd)), (f"{stack}.attn.wo", (n, H * hd, D))]


def leaves(a: Arch, attn_leaves=mha_leaves) -> List[Tuple[str, tuple]]:
    """[(dotted path, shape)] of every parameter, layers stacked in front."""
    D, Vp = a.d_model, a.padded_vocab
    out = [("embed.w", (Vp, D)), ("final_norm.w", (D,))]
    if not a.tie_embeddings:
        out.append(("lm_head.w", (D, Vp)))
    for stack, n, is_moe in a.stacks():
        out += attn_leaves(a, stack, n) + [(f"{stack}.ln1.w", (n, D)), (f"{stack}.ln2.w", (n, D))]
        if is_moe:
            m = a.moe
            E, Fe = m.n_experts, m.d_ff_expert
            out += [(f"{stack}.moe.router", (n, D, E)), (f"{stack}.moe.wi", (n, E, D, Fe)),
                    (f"{stack}.moe.wg", (n, E, D, Fe)), (f"{stack}.moe.wo", (n, E, Fe, D))]
            if m.n_shared:
                Fs = Fe * m.n_shared
                out += [(f"{stack}.moe.shared.wi", (n, D, Fs)),
                        (f"{stack}.moe.shared.wg", (n, D, Fs)),
                        (f"{stack}.moe.shared.wo", (n, Fs, D))]
        else:
            out += [(f"{stack}.mlp.wi", (n, D, a.d_ff)), (f"{stack}.mlp.wg", (n, D, a.d_ff)),
                    (f"{stack}.mlp.wo", (n, a.d_ff, D))]
    return out


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x: (B, H, S, d); pairs (2i, 2i + 1) rotated by position * theta^(-2i/d)."""
    d, S = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def attention(q, k, v, mm: Products, block: int = 1024):
    """Causal softmax attention, queries in blocks of ``block``."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    q = q * (1.0 / math.sqrt(d))
    outs = []
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        s = mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2))
        late = (torch.arange(hi, device=q.device)[None, :]
                > torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(late, float("-inf"))
        outs.append(mm(torch.softmax(s, dim=-1), v[:, :, :hi]))
    return torch.cat(outs, dim=2)


def mlp(x, wi, wg, wo, mm: Products):
    return mm(F.silu(mm(x, wg)) * mm(x, wi), wo)


def route(probs, k: int):
    """The k most probable experts of each token, the lower index first
    among equals."""
    return torch.sort(probs.detach(), dim=-1, descending=True, stable=True)[1][..., :k]


def moe(h, p: Dict[str, torch.Tensor], a: Arch, mm: Products):
    """(out, load-balance + router-z loss) of one MoE layer."""
    m = a.moe
    B, S, D = h.shape
    E, K = m.n_experts, m.top_k
    C = min(max(int(K * S * m.capacity_factor / E), 1), S)
    logits = mm(h, p["moe.router"])
    probs = torch.softmax(logits, dim=-1)
    idx = route(probs, K)
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = idx.reshape(B, S * K)                                  # (s, k) priority order
    onehot = F.one_hot(flat, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot, -1, flat[..., None])[..., 0]
    keep = (pos < C).reshape(-1)
    rows = torch.arange(B, device=h.device)[:, None].expand(B, S * K).reshape(-1)
    tok = (torch.arange(S * K, device=h.device) // K)[None].expand(B, S * K).reshape(-1)
    expert = flat.reshape(-1)
    kept = keep.nonzero()[:, 0]
    kept = kept[torch.argsort(expert[kept], stable=True)]
    counts = torch.bincount(expert[kept], minlength=E).tolist()
    xs = h.reshape(B * S, D)
    where = rows[kept] * S + tok[kept]
    ys = []
    for e, part in enumerate(torch.split(torch.arange(kept.numel(), device=h.device), counts)):
        if part.numel():
            ys.append(mlp(xs[where[part]], p["moe.wi"][e], p["moe.wg"][e], p["moe.wo"][e], mm))
    y = torch.cat(ys) * gates.reshape(-1)[kept][:, None]
    out = torch.zeros_like(xs).index_add(0, where, y).reshape(B, S, D)
    if m.n_shared:
        out = out + mlp(h, p["moe.shared.wi"], p["moe.shared.wg"], p["moe.shared.wo"], mm)
    top1 = F.one_hot(idx[..., 0], E).float()
    lb = E * torch.sum(top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))) * m.load_balance_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_loss
    return out, lb + z


def mha(h, p: Dict[str, torch.Tensor], a: Arch, mm: Products):
    """The attention sublayer of one layer: (B, S, D) normalised -> (B, S, D)."""
    B, S, _ = h.shape
    H, KV, hd = a.n_heads, a.n_kv_heads, a.head_dim
    q, k, v = (mm(h, p[f"attn.{w}"]).reshape(B, S, n, hd).transpose(1, 2)
               for w, n in (("wq", H), ("wk", KV), ("wv", KV)))
    o = attention(rope(q, a.rope_theta), rope(k, a.rope_theta), v, mm)
    return mm(o.transpose(1, 2).reshape(B, S, H * hd), p["attn.wo"])


def block(x, p: Dict[str, torch.Tensor], a: Arch, is_moe: bool, mm: Products, attend=mha):
    h = rms_norm(x, p["ln1.w"], a.norm_eps)
    x = x + attend(h, p, a, mm)
    h = rms_norm(x, p["ln2.w"], a.norm_eps)
    if is_moe:
        y, aux = moe(h, p, a, mm)
    else:
        y, aux = mlp(h, p["mlp.wi"], p["mlp.wg"], p["mlp.wo"], mm), torch.zeros((), device=x.device)
    return x + y, aux


def _xent_sum(x, head, labels, weight, vocab: int, mm: Products):
    logits = mm(x, head)
    if head.shape[-1] > vocab:
        pad = torch.arange(head.shape[-1], device=x.device) >= vocab
        logits = logits.masked_fill(pad, NEG)
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(nll * weight)


def loss(params: Dict[str, torch.Tensor], tokens, labels, a: Arch, mm: Products,
         half: bool = False, attend=mha):
    """Mean cross-entropy plus the MoE losses.  ``half``: a planted fault,
    the mean taken over the first half of the batch's tokens only;
    ``attend``: each layer's attention sublayer."""
    B, S = tokens.shape
    x = params["embed.w"][tokens.long()]
    aux = torch.zeros((), device=x.device)
    for stack, n, is_moe in a.stacks():
        for i in range(n):
            lp = {k[len(stack) + 1:]: w[i] for k, w in params.items()
                  if k.startswith(stack + ".")}
            x, au = checkpoint(block, x, lp, a, is_moe, mm, attend, use_reentrant=False)
            aux = aux + au
    x = rms_norm(x, params["final_norm.w"], a.norm_eps)
    head = params["embed.w"].T if a.tie_embeddings else params["lm_head.w"]
    weight = torch.ones((B, S), device=x.device)
    count = B * S
    if half:
        weight = (torch.arange(B * S, device=x.device) < B * S // 2).float().reshape(B, S)
        count = B * S // 2
    chunk = a.logit_chunk if S % a.logit_chunk == 0 else S
    xent = torch.zeros((), device=x.device)
    for lo in range(0, S, chunk):
        sl = slice(lo, lo + chunk)
        xent = xent + checkpoint(_xent_sum, x[:, sl], head, labels[:, sl].long(), weight[:, sl],
                                 a.vocab, mm, use_reentrant=False)
    return xent / count + aux
