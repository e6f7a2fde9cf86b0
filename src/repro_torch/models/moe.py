"""Mixture-of-Experts with GShard-style einsum dispatch.

Counterpart of ``repro/models/moe.py``: dense one-hot dispatch and combine
einsums, per-batch-row groups with a capacity factor (tokens over capacity
drop through the residual connection), the router in float32, and the
load-balance and router-z auxiliary losses.

One choice is made on purpose.  ``jax.lax.top_k`` puts the lower expert
index first among equal router probabilities; ``torch.topk`` promises no
order, and exact ties do happen (router logits come out of a bf16
product).  The order decides the capacity priority over the flattened
(s, k) and the load-balance loss's top-1, so the top k are taken by a
stable descending sort, which keeps JAX's order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import Params, _model_only, dense_init, init_mlp, mlp, torch_dtype
from repro_torch.parallel import sharding as shd


def expert_capacity(moe: MoEConfig, group_tokens: int) -> int:
    cap = int(moe.top_k * group_tokens * moe.capacity_factor / moe.num_experts)
    return max(cap, 1)


def init_moe(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    moe = cfg.moe
    assert moe is not None
    d_ff = moe.d_ff_expert or cfg.d_ff
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    E, D = moe.num_experts, cfg.d_model
    p: Params = {
        "router": dense_init(gen, lead + (D, E), dtype, scale=0.02, device=device),
        "wi": dense_init(gen, lead + (E, D, d_ff), dtype, device=device),
        "wg": dense_init(gen, lead + (E, D, d_ff), dtype, device=device),
        "wo": dense_init(gen, lead + (E, d_ff, D), dtype, device=device),
    }
    if moe.num_shared_experts:
        p["shared"] = init_mlp(gen, D, d_ff * moe.num_shared_experts, dtype, n_layers,
                               device=device)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties broken by the lower index
    first (``jax.lax.top_k``'s order).  The values are gathered at the
    sorted indices, so that the gradient is ``gather``'s scatter into zeros
    laid out like ``probs`` (``sort``'s backward scatters into a replicated
    buffer, which some torch releases meet on DTensors by gathering the
    batch whole)."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(probs, -1, idx), idx


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, n).to(dtype)`` as a comparison with ``arange(n)``: the
    same values, and on DTensors an elementwise op that keeps ``idx``'s
    sharding.  ``F.one_hot`` scatters into a replicated zero tensor, and
    some torch releases gather the sharded index whole to do it."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _experts(x, disp, comb, wg, wi, wo):
    """Dispatch, the experts' SwiGLU and the combine: (B, S, D) -> (B, S, D)."""
    dt = x.dtype
    xin = torch.einsum("bsec,bsd->ebcd", disp.to(dt), x)         # (E,B,C,D)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xin, wg))
    h = h * torch.einsum("ebcd,edf->ebcf", xin, wi)
    out_e = torch.einsum("ebcf,efd->ebcd", h, wo)                # (E,B,C,D)
    return torch.einsum("bsec,ebcd->bsd", comb.to(dt), out_e)


def _experts_on_shards(x, disp, comb, wg, wi, wo):
    """``_experts``, on DTensors each rank on its shards (``local_map``):
    its batch rows (``sharding.row_placements``) and, over `model`, the
    experts or the d_ff columns the weights' specs split there (the expert
    weights gathered over every other axis).  The output is a pending sum
    over `model`.  DTensor's own strategies for the einsums flatten (expert,
    batch) into one dim sharded over up to three mesh axes, and gather it
    whole where the batch lies on two."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return _experts(x, disp, comb, wg, wi, wo)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = shd.row_placements(mesh, x.shape[0])
    split = wi.placements[names.index("model")] if "model" in names else Replicate()
    whole = [Replicate()] * len(names)
    if split.is_shard(0):                                         # expert parallel
        oh = shd.with_model(mesh, rows, Shard(2))
        w_in = w_out = shd.with_model(mesh, whole, Shard(0))
    elif split.is_shard(2):                                       # d_ff over `model`
        oh, w_in, w_out = rows, shd.with_model(mesh, whole, Shard(2)), shd.with_model(mesh, whole, Shard(1))
    else:
        oh, w_in, w_out = rows, whole, whole
    out = shd.with_model(mesh, rows, Partial()) if split.is_shard() else rows
    fn = shd.on_shards(_experts, mesh, (rows, oh, oh, w_in, w_in, w_out), out)
    return fn(x, disp, comb, wg, wi, wo)


def moe_block(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out, aux_losses).  Groups are batch rows: capacity
    is computed over the S tokens of a row."""
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.num_experts, moe.top_k
    C = min(expert_capacity(moe, S), S)

    logits = (x @ _model_only(params["router"])).float()        # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                        # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # position-in-expert for capacity masking: sel (B,S,K,E) one-hot of the
    # chosen experts, ranked by (s, k) priority
    sel = _one_hot(gate_idx, E, torch.float32)
    flat = sel.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)  # tokens ahead
    sel = sel * (pos < C)
    pos_idx = (pos * sel).sum(-1).long()                         # (B,S,K)

    # dispatch/combine tensors (B,S,E,C); one-hots are exact in bf16
    oh_dt = torch.bfloat16 if cfg.bf16_stream else torch.float32
    pos_oh = _one_hot(pos_idx, C, oh_dt)                         # (B,S,K,C)
    sel_oh = sel.to(oh_dt)
    disp = torch.einsum("bske,bskc->bsec", sel_oh, pos_oh)
    # JAX contracts sel, pos_oh and the gates in one einsum; at most one k
    # picks a given expert, so scaling sel by the gate first is exact
    comb = torch.einsum("bske,bskc->bsec", sel_oh * gate_vals.to(oh_dt)[..., None], pos_oh)

    out = _experts_on_shards(x, disp, comb, params["wg"], params["wi"], params["wo"])

    if moe.num_shared_experts and "shared" in params:
        out = out + mlp(params["shared"], x)

    # auxiliary losses: load balance E * sum_e f_e * p_e (Switch Transformer
    # eq. 4-6) and the router z-loss
    top1 = _one_hot(gate_idx[..., 0], E, torch.float32)
    f = shd.row_mean(top1, (0, 1))
    p = shd.row_mean(probs, (0, 1))
    lb = E * torch.sum(f * p) * moe.load_balance_loss
    z = shd.row_mean(torch.logsumexp(logits, dim=-1) ** 2, (0, 1)) * moe.router_z_loss
    return out, {"load_balance": lb, "router_z": z}
