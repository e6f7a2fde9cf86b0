"""Attention variants: chunked online-softmax attention as plain tensor
code, the dispatch to the hand-written flash kernel, the GQA block, MLA
(DeepSeek-V2 multi-head latent attention), and single-token decode against
a ring-buffer cache (K/V for GQA, the latent and the shared rope key for
MLA).

Memory discipline: the plain path never materializes an (Sq, Skv) score
matrix larger than (chunk, chunk) per (batch, kv-head, group).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.models.layers import (Params, _device_of, _model_only, apply_rope, dense_init,
                                       rms_norm, torch_dtype)
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import write_at

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked online-softmax attention core
# ---------------------------------------------------------------------------

def _flash_core(q, k, v, q_lo: int, *, causal: bool, window: int, chunk: int):
    """q: (B, Hkv, G, Sq, d); k, v: (B, Hkv, Skv, d).

    The queries sit at absolute positions ``q_lo .. q_lo + Sq - 1``, the
    keys at ``0 .. Skv - 1``.  Which KV chunks to skip is decided from those
    Python ints, never from a tensor, so the walk reads nothing back from
    the device (and traces on meta or fake tensors).  Returns (B, Hkv, G, Sq,
    d).  Walks the KV chunks with a running (max, denominator, accumulator)
    triple; f32 accumulation.
    """
    B, Hkv, G, Sq, d = q.shape
    dv = v.shape[-1]
    Skv = k.shape[2]
    chunk = min(chunk, Skv)
    if Skv % chunk != 0:
        chunk = Skv
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    q_hi = q_lo + Sq - 1
    q_pos = q_lo + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, chunk):
        pc = kv_pos[start:start + chunk]
        # a block no query can see adds exact zeros (p = exp(-1e30 - m) = 0
        # once m is finite, which the first block guarantees): skip it
        if start > 0 and ((causal and start > q_hi)
                          or (window and start + pc.shape[0] - 1 <= q_lo - window)):
            continue
        kc = k[:, :, start:start + chunk].float()
        vc = v[:, :, start:start + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc)
        mask = torch.ones((Sq, pc.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pc[None, :] <= q_pos[:, None]
        if window:
            mask &= pc[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def use_pallas(cfg, x: torch.Tensor) -> bool:
    """Kernel dispatch policy (the field keeps its JAX name): the
    hand-written kernel on a CUDA tensor, or when forced for tests."""
    mode = getattr(cfg, "use_pallas", "auto")
    if mode == "always":
        return True
    if mode == "never":
        return False
    return x.is_cuda


class _FlashKernelFn(torch.autograd.Function):
    """Kernel forward with the plain path's gradients (recomputed in
    backward), the standard pattern until a backward kernel lands."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        B, Hq, Sq, d = q.shape
        Hkv = k.shape[1]
        out = flash_attention_cuda(
            q.reshape(B * Hq, Sq, d).contiguous(),
            k.reshape(B * Hkv, k.shape[2], d).contiguous(),
            v.reshape(B * Hkv, v.shape[2], d).contiguous(),
            causal=causal, n_heads=Hq, n_kv_heads=Hkv)
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return out.reshape(B, Hq, Sq, d)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _flash_reference(q, k, v, ctx.causal)
        grads = torch.autograd.grad(out, (q, k, v), g)
        return (*(t.contiguous() for t in grads), None)


def _flash_pallas_cv(q, k, v, causal: bool):
    return _FlashKernelFn.apply(q, k, v, causal)


def _on_shards(q, k, v, fn):
    """``fn(q, k, v)`` on each rank's shards of DTensor q, k, v (B, H, S, d)
    (``local_map``), the attention's fixed lowering on a mesh.  Attention is
    independent per (batch row, kv head): the batch rows split over the
    axes the specs split a batch of B over (``sharding.batch_shardable``),
    and over `model`:

    - the kv heads, where they divide it (query head h reads kv head
      h // G, and the query heads split as evenly);
    - else the (row, kv head) pairs, where they divide the rows' axes and
      `model` together: (B, H, S, d) is flattened to (B * Hkv, G, S, d), a
      kv head and its G query heads a row (8 kv heads on 16 ranks:
      internvl2, command-r, Jamba's attention, Whisper);
    - else every `model` rank takes them all.

    DTensor's own strategies for the batched products inside would
    otherwise choose, op by op, by the torch release's cost model: with the
    batch over two mesh axes and the heads over a third, the flattened
    (batch x head) dim of the scores is sharded three ways, and they gather
    it whole."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    m = shd.mesh_axis_size(mesh, "model")
    B, Hq, Sq, _ = q.shape
    Hkv = k.shape[1]
    rows = shd.row_placements(mesh, B)
    ways = m * math.prod(shd.mesh_axis_size(mesh, a) for a in shd.batch_shardable(mesh, B) or ())
    if Hkv % m and B * Hkv % ways == 0:
        pl = shd.with_model(mesh, rows, Shard(0))
        q, k, v = (t.reshape(B * Hkv, -1, *t.shape[2:]).contiguous() for t in (q, k, v))
        return shd.on_shards(fn, mesh, (pl, pl, pl), pl)(q, k, v).reshape(B, Hq, Sq, -1)
    pl = shd.with_model(mesh, rows, Shard(1) if Hkv % m == 0 else Replicate())
    return shd.on_shards(fn, mesh, (pl, pl, pl), pl)(q, k, v)


def _flash_reference(q, k, v, causal):
    return flash_attention(q, k, v, causal=causal, chunk=1024, _allow_pallas=False)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    chunk: int = 1024, q_offset: int = 0,
                    cfg=None, _allow_pallas: bool = True) -> torch.Tensor:
    """GQA-aware chunked attention.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d); Hq % Hkv == 0.
    ``q_offset`` shifts query positions (prefill continuation).  Queries are
    processed in blocks of ``chunk`` so a long sequence never holds more
    than one (chunk x chunk) score tile per head-group.

    When ``cfg.use_pallas`` resolves true and the shape qualifies (no
    window/offset, same qk/v dims, 128-aligned), dispatches to the
    hand-written flash kernel (``repro_torch.kernels.flash_attn``).

    On DTensors each rank runs this on its shards (``_on_shards``).
    """
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _on_shards(q, k, v, lambda q, k, v: flash_attention(
            q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset, cfg=cfg,
            _allow_pallas=_allow_pallas))
    if (_allow_pallas and cfg is not None and use_pallas(cfg, q)
            and window == 0 and q_offset == 0
            and q.shape[-1] == v.shape[-1]
            and q.shape[2] % 128 == 0 and k.shape[2] % 128 == 0):
        return _flash_pallas_cv(q, k, v, causal)
    B, Hq, Sq, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, d)

    qchunk = min(chunk, Sq)
    if Sq % qchunk != 0:
        qchunk = Sq
    outs = []
    for i in range(Sq // qchunk):
        outs.append(_flash_core(qg[:, :, :, i * qchunk:(i + 1) * qchunk], k, v,
                                q_offset + i * qchunk, causal=causal, window=window,
                                chunk=chunk))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.reshape(B, Hq, Sq, v.shape[-1])


def _softmax_weigh(s, weigh, groups=()) -> torch.Tensor:
    """``weigh(softmax(s))``, the softmax over the last dim of the float32
    scores ``s``, ``weigh`` linear in its weights (their sum over that dim
    against the values).  ``groups``: the process groups that split that
    dim, each rank holding its slots' scores; each rank's running max,
    denominator and weighted values are all-reduced over them
    (flash-decoding's merge).  No groups: one rank's softmax."""
    from torch.distributed import _functional_collectives as funcol

    m = s.amax(dim=-1)
    for g in groups:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
    p = torch.exp(s - m[..., None])
    den, out = p.sum(dim=-1), weigh(p)
    for g in groups:
        den = funcol.wait_tensor(funcol.all_reduce(den, "sum", g))
        out = funcol.wait_tensor(funcol.all_reduce(out, "sum", g))
    return out / den[..., None]


def decode_attention(q, k, v, valid_mask, groups=()) -> torch.Tensor:
    """Single-token attention.  q: (B, Hq, 1, d); k, v: (B, Hkv, S, d);
    valid_mask: (B, S) bool (ring-buffer slots that hold real tokens).
    ``groups``: the process groups that split the S slots
    (``_softmax_weigh``)."""
    B, Hq, _, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, d).float() / math.sqrt(d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float())
    s = torch.where(valid_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    out = _softmax_weigh(s, lambda p: torch.einsum("bhgk,bhkd->bhgd", p, v.float()), groups)
    return out.reshape(B, Hq, 1, d).to(q.dtype)


def _cache_split(cache, slot_dim: int):
    """(first slot, groups) of this rank's shard of a decode cache whose
    slots lie along ``slot_dim``: the global index of its first slot and the
    process groups of the mesh axes that split the slots.  Plain tensors:
    (0, ())."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if not isinstance(cache, DTensor):
        return 0, ()
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    lo = compute_local_shape_and_global_offset(cache.shape, mesh, pl)[1][slot_dim]
    return lo, tuple(mesh.get_group(i) for i, p in enumerate(pl) if p.is_shard(slot_dim))


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    return {
        "wq": dense_init(gen, lead + (D, H * hd), dtype, device=device),
        "wk": dense_init(gen, lead + (D, KV * hd), dtype, device=device),
        "wv": dense_init(gen, lead + (D, KV * hd), dtype, device=device),
        "wo": dense_init(gen, lead + (H * hd, D), dtype, device=device),
    }


def gqa_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                q_offset: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill path.  x: (B, S, D) -> (out, cache)."""
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # where the kv heads do not divide `model` the attention splits its
    # (row, kv head) pairs over it (``_on_shards``): the gradients of q, k
    # and v are placed back on the projections' column shards before the
    # products' backward, which DTensor would otherwise run whole
    q, k, v = (shd.grad_as_placed(x @ params[w]).reshape(B, S, n, hd).transpose(1, 2)
               for w, n in (("wq", H), ("wk", KV), ("wv", KV)))
    pos = q_offset + torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          chunk=cfg.attn_chunk, q_offset=q_offset, cfg=cfg)
    out = shd.constrain_cols(out.transpose(1, 2).reshape(B, S, H * hd))
    cache = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}      # (B, S, KV, hd)
    return out @ params["wo"], cache


def _decode_on_shards(q, k, v, n_valid: int):
    """``decode_attention`` over the first ``n_valid`` slots of the cache
    (B, KV, W, hd).  On DTensors each rank attends with its own shards
    (``sharding.on_shards``) in the cache's layout: its batch rows, its kv
    heads where `model` splits them, and its slots where the cache is split
    along W (``_cache_split``; flash-decoding).  DTensor's own strategies
    for the batched products gather the cache whole over `model`, or reduce
    the softmax in pieces, by choices that differ by torch release."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lo, groups = _cache_split(k, 2)

    def attend(q, k, v):
        valid = (lo + torch.arange(k.shape[2], device=q.device)) < n_valid
        return decode_attention(q, k, v, valid[None, :].expand(q.shape[0], k.shape[2]), groups)

    if not isinstance(k, DTensor):
        return attend(q, k, v)
    mesh, kpl = k.device_mesh, tuple(k.placements)
    if any(p.is_shard() and p.dim == 3 for p in kpl) or any(not (p.is_shard() or p.is_replicate())
                                                            for p in kpl):
        raise ValueError(f"a decode cache placed {kpl} is not one the specs give")
    qpl = [Shard(p.dim) if p.is_shard() and p.dim < 2 else Replicate() for p in kpl]
    return shd.on_shards(attend, mesh, (qpl, kpl, kpl), qpl)(q, k, v)


def gqa_decode(params: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cache_index: int, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, D); cache k/v: (B, W, KV, hd) ring buffer
    (W = sliding window if set, else max seq); cache_index: count of tokens
    already written.  The new token's k/v go into slot ``cache_index % W``
    *in place* (JAX returns an updated copy); the returned cache is the
    same dict."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = cache["k"].shape[1]
    cache_index = int(cache_index)
    q = (x @ params["wq"]).reshape(B, 1, H, hd).transpose(1, 2)
    k = (x @ params["wk"]).reshape(B, 1, KV, hd)
    v = (x @ params["wv"]).reshape(B, 1, KV, hd)
    pos = torch.tensor([cache_index], device=x.device)           # absolute position
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
    slot = cache_index % W
    write_at(cache["k"], 1, slot, k[:, 0])
    write_at(cache["v"], 1, slot, v[:, 0])
    n_valid = min(cache_index + 1, W)
    out = _decode_on_shards(q, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2), n_valid)
    out = out.transpose(1, 2).reshape(B, 1, H * hd)
    return out @ params["wo"], cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    L, R = cfg.mla_kv_lora, cfg.mla_rope_dim
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    return {
        "w_dkv": dense_init(gen, lead + (D, L), dtype, device=device),      # down-proj to latent
        "w_kr": dense_init(gen, lead + (D, R), dtype, device=device),       # shared rope key
        "w_uk": dense_init(gen, lead + (L, H * hd), dtype, device=device),  # up-proj keys
        "w_uv": dense_init(gen, lead + (L, H * hd), dtype, device=device),  # up-proj values
        "w_q": dense_init(gen, lead + (D, H * (hd + R)), dtype, device=device),
        "w_o": dense_init(gen, lead + (H * hd, D), dtype, device=device),
        "ln_kv": torch.ones(lead + (L,), dtype=dtype, device=_device_of(gen, device)),
    }


def _mla_qkv(params, x, cfg: ModelConfig, pos):
    """Shared projections.  Returns q_nope (B, H, S, hd), q_rope (B, H, S,
    R), the latent c_kv (B, S, L) and k_rope (B, S, R)."""
    B, S, _ = x.shape
    H, hd, R = cfg.num_heads, cfg.head_dim, cfg.mla_rope_dim
    # x's gradient from q (a pending sum over `model`) reduced before it
    # meets the latent projections' (whole over `model`)
    q = (shd.constrain_rows(x) @ _model_only(params["w_q"])).reshape(B, S, H, hd + R)
    q = q.transpose(1, 2)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    # the latent and rope-key projections are whole over `model`: split by
    # tokens (``sharding.on_tokens``), then gathered to rows
    c_kv, k_rope = (shd.constrain_rows(shd.on_tokens(torch.matmul, (x,), (params[k],)))
                    for k in ("w_dkv", "w_kr"))
    c_kv = rms_norm(c_kv, params["ln_kv"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, None], pos, cfg.rope_theta)[:, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                q_offset: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill path.  x: (B, S, D) -> (out, {c_kv, k_rope}).
    The attention is called without ``cfg`` and its q/k dim (hd + R) is not
    its v dim (hd), so it never takes the flash kernel, as in JAX."""
    B, S, _ = x.shape
    H, hd, R = cfg.num_heads, cfg.head_dim, cfg.mla_rope_dim
    pos = q_offset + torch.arange(S, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, pos)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, H, hd).transpose(1, 2)
    v = (c_kv @ params["w_uv"]).reshape(B, S, H, hd).transpose(1, 2)
    # fold the shared rope key into every head by concatenation
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, None].expand(B, H, S, R)], dim=-1)
    out = flash_attention(q_full, k_full, v, causal=True, window=cfg.sliding_window,
                          chunk=cfg.attn_chunk, q_offset=q_offset)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ params["w_o"], {"c_kv": c_kv, "k_rope": k_rope}


def _latent_on_shards(q_lat, q_rope, c_kv, k_rope, n_valid: int, divisor: float):
    """MLA decode's attention in the latent space: (B, H, L) context over
    the first ``n_valid`` slots of the latent cache c_kv (B, W, L) and rope
    keys (B, W, R), the summed scores divided by ``divisor`` as the
    reference divides them.  On DTensors each rank attends with its cache
    shard's rows and slots, every head (``sharding.on_shards``), merged over
    the axes that split W as ``_decode_on_shards`` does."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lo, groups = _cache_split(c_kv, 1)

    def attend(q_lat, q_rope, c_kv, k_rope):
        s = torch.einsum("bhl,bwl->bhw", q_lat.float(), c_kv.float())
        s = (s + torch.einsum("bhr,bwr->bhw", q_rope.float(), k_rope.float())) / divisor
        slot = lo + torch.arange(c_kv.shape[1], device=c_kv.device)
        s = torch.where((slot < n_valid)[None, None, :], s, torch.full_like(s, NEG_INF))
        return _softmax_weigh(s, lambda p: torch.einsum("bhw,bwl->bhl", p, c_kv.float()), groups)

    if not isinstance(c_kv, DTensor):
        return attend(q_lat, q_rope, c_kv, k_rope)
    mesh, kpl = c_kv.device_mesh, tuple(c_kv.placements)
    if any(not (p.is_shard(0) or p.is_shard(1) or p.is_replicate()) for p in kpl):
        raise ValueError(f"a latent cache placed {kpl} is not one the specs give")
    qpl = [Shard(0) if p.is_shard(0) else Replicate() for p in kpl]
    return shd.on_shards(attend, mesh, (qpl, qpl, kpl, tuple(k_rope.placements)), qpl)(
        q_lat, q_rope, c_kv, k_rope)


def mla_decode(params: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cache_index: int, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the latent cache: c_kv (B, W, L), k_rope
    (B, W, R).  The new token's latent and rope key go into slot
    ``cache_index % W`` in place, as in ``gqa_decode``; ``w_uk`` is absorbed
    into the query, so the scores are taken in the latent space."""
    B = x.shape[0]
    H, hd, R = cfg.num_heads, cfg.head_dim, cfg.mla_rope_dim
    W = cache["c_kv"].shape[1]
    cache_index = int(cache_index)
    pos = torch.tensor([cache_index], device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(params, x, cfg, pos)
    slot = cache_index % W
    write_at(cache["c_kv"], 1, slot, c_new[:, 0])
    write_at(cache["k_rope"], 1, slot, kr_new[:, 0])
    n_valid = min(cache_index + 1, W)
    # (B, H, hd) x (L, H, hd) -> the query in the latent space (B, H, L)
    # the up-projections and w_o gathered over the fsdp axis (``_model_only``):
    # their contracted dims would otherwise meet the batch rows split over it
    w_uk = _model_only(params["w_uk"]).reshape(-1, H, hd)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, :, 0], w_uk)
    ctx = _latent_on_shards(q_lat, q_rope[:, :, 0], cache["c_kv"], cache["k_rope"], n_valid,
                            math.sqrt(hd + R))                            # latent context
    w_uv = _model_only(params["w_uv"]).reshape(-1, H, hd)
    out = torch.einsum("bhl,lhd->bhd", ctx, w_uv.float())
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ _model_only(params["w_o"]), cache
