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
from repro_torch.models.layers import Params, dense_init, init_mlp, mlp, project, torch_dtype
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


def _expert_in(x, disp, wg, wi):
    """The dispatch and the experts' two input products: (E, B, C, F) each."""
    xin = torch.einsum("bsec,bsd->ebcd", disp.to(x.dtype), x)    # (E,B,C,D)
    return torch.einsum("ebcd,edf->ebcf", xin, wg), torch.einsum("ebcd,edf->ebcf", xin, wi)


def _expert_out(g, i, comb, wo):
    """The experts' SwiGLU from its two input products, their output
    product and the combine: (B, S, D)."""
    out_e = torch.einsum("ebcf,efd->ebcd", F.silu(g) * i, wo)    # (E,B,C,D)
    return torch.einsum("bsec,ebcd->bsd", comb.to(out_e.dtype), out_e)


def _experts(x, disp, comb, wg, wi, wo):
    """Dispatch, the experts' SwiGLU and the combine: (B, S, D) -> (B, S, D)."""
    return _expert_out(*_expert_in(x, disp, wg, wi), comb, wo)


def _experts_rows_whole(x, disp, comb, wg, wi, wo):
    """``_experts`` where the batch rows are whole over `data`
    (``sharding.rows_whole``; ``x`` the stream split on d_model over it),
    each rank on the expert weights' own shards (``sharding.on_shards``):
    over `model` its experts or d_ff columns, as ``_experts_on_shards``;
    over `data` the weights' fsdp split.  Where that split is on d_model
    (or there is none: a whole weight is sliced), the input products
    contract each rank's d_model slice, pending sums all-reduced over
    `data`, and the output product writes its d_model slice, the stream's
    own; where it is on d_ff (``moe_shard="edim_dff"``) the stream is
    gathered over `data`, the input products write each rank's d_ff slice
    and the output product is a pending sum.  The output is a pending sum
    over `model`."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names

    def pl(data, model):
        return [data if n == "data" else model if n == "model" else Replicate() for n in names]
    model = wi.placements[names.index("model")]
    ep, dff = model.is_shard(0), model.is_shard(2)                # experts | d_ff over `model`
    d_dff = wi.placements[names.index("data")].is_shard(2)        # fsdp on d_ff
    w_in = pl(Shard(2) if d_dff else Shard(1), model)
    hpl = pl(Shard(3) if d_dff else Partial(), Shard(0) if ep else Shard(3) if dff else Replicate())
    oh = pl(Replicate(), Shard(2) if ep else Replicate())
    xpl = pl(Replicate() if d_dff else Shard(2), Replicate())
    g, i = shd.on_shards(_expert_in, mesh, (xpl, oh, w_in, w_in), (hpl, hpl))(x, disp, wg, wi)
    if not d_dff:
        g, i = (t.redistribute(mesh, pl(Replicate(), t.placements[names.index("model")]))
                for t in (g, i))
    w_out = pl(Shard(1) if d_dff else Shard(2), Shard(0) if ep else Shard(1) if dff else Replicate())
    out = pl(Partial() if d_dff else Shard(2), Partial() if ep or dff else Replicate())
    hpl = [Replicate() if p.is_partial() else p for p in hpl]
    return shd.on_shards(_expert_out, mesh, (hpl, hpl, oh, w_out), out)(g, i, comb, wo)


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
    if shd.rows_whole(x):
        return _experts_rows_whole(x, disp, comb, wg, wi, wo)
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
    data = names.index("data") if "data" in names else None
    if (split.is_shard(0) and data is not None and rows[data].is_shard()
            and wo.placements[data].is_shard(2) and x.shape[0] * disp.shape[-1] < wo.shape[-1]):
        # a decode step: its few rows gathered over `data` for the output
        # product and the combine, wo left on its d_model columns, one
        # all-to-all back to the rows (sharding.rows_gathered)
        h = shd.with_model(mesh, [Shard(1) if p.is_shard() else p for p in rows], Shard(0))
        g, i = shd.on_shards(_expert_in, mesh, (rows, oh, w_in, w_in), (h, h))(x, disp, wg, wi)
        h_all, oh_all = ([Replicate() if k == data else p for k, p in enumerate(t)] for t in (h, oh))
        w_cols = [Shard(2) if k == data else p for k, p in enumerate(w_out)]
        return shd.on_shards(lambda *t: shd.rows_to_columns(_expert_out(*t), mesh, "data"), mesh,
                             (h_all, h_all, oh_all, w_cols), out)(g, i, comb, wo)
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

    logits = project(x, params["router"], True)
    if shd.rows_whole(x):                    # its columns split over `model` (sharding.linear)
        logits = shd.constrain_rows(logits)
    logits = logits.float()                                      # (B,S,E)
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
