"""RWKV-6 "Finch": attention-free time-mix with data-dependent decay.

Counterpart of ``repro/models/rwkv.py``.  The WKV recurrence per head
(state S in R^{hd x hd}):

    y_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(-exp(w0 + lora(x)))

Kernel dispatch differs from the reference on purpose.  JAX sends a WKV
call to its Pallas kernel only for ``S > 1`` and ``S % chunk_size == 0``,
and everything else (every ``S = 1`` decode step) to the chunked jnp form,
because its kernel walks whole chunks.  The port's wrapper
(``repro_torch.kernels.wkv``) has two hand-written kernels and takes any S:
a chunked one on the tensor cores for S >= 64 (a prefill, a training
step; any S past the last whole chunk included) and one that runs the
recurrence a step at a time for the rest (every decode step).  So on a
CUDA tensor, with ``use_pallas`` not ``never``, *every* WKV call goes
through a kernel, decode included: no plain code on the card's serving
path.  Both read the model's (B, S, H, hd) tensors through their strides
(no transposes).  The gradient is the chunked form's, recomputed in
backward, as ``_wkv_pallas_cv`` does in JAX.

Token-shift is the static-mix variant of the reference (the
data-dependent decay is kept).  The four mixing/decay leaves ``w_decay``,
``u_bonus``, ``mix`` and ``mix_ch`` are float32 whatever ``cfg.dtype`` is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv import wkv, wkv_plain
from repro_torch.models.attention import use_pallas
from repro_torch.models.layers import (Params, _device_of, chunked_softmax_xent, dense_init,
                                       embed_init, project, rms_norm, torch_dtype)
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import lookup
from repro_torch.utils.tree import tree_map

DECAY_LORA = 64


def head_dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_time_mix(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    D = cfg.d_model
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    dev = _device_of(gen, device)
    f32 = dict(dtype=torch.float32, device=dev)
    # per-channel decay-speed init (RWKV convention): slow channels keep
    # long-range state, fast channels decay within a few tokens
    ratio = torch.arange(D, **f32) / max(D - 1, 1)
    w0 = -6.0 + 5.0 * ratio ** 0.7
    return {
        "w_r": dense_init(gen, lead + (D, D), dtype, device=device),
        "w_k": dense_init(gen, lead + (D, D), dtype, device=device),
        "w_v": dense_init(gen, lead + (D, D), dtype, device=device),
        "w_g": dense_init(gen, lead + (D, D), dtype, device=device),
        "w_o": dense_init(gen, lead + (D, D), dtype, device=device),
        "w_decay": w0 * torch.ones(lead + (D,), **f32),
        "w_decay_lora_a": dense_init(gen, lead + (D, DECAY_LORA), dtype, scale=0.01, device=device),
        "w_decay_lora_b": dense_init(gen, lead + (DECAY_LORA, D), dtype, scale=0.01, device=device),
        "u_bonus": torch.zeros(lead + (D,), **f32),
        "mix": 0.5 * torch.ones(lead + (5, D), **f32),         # r, k, v, w, g
        "ln_x": torch.ones(lead + (D,), dtype=dtype, device=dev),   # per-head group norm
    }


def init_channel_mix(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    return {
        "wr_ch": dense_init(gen, lead + (D, D), dtype, device=device),
        "wk_ch": dense_init(gen, lead + (D, Fd), dtype, device=device),
        "wv_ch": dense_init(gen, lead + (Fd, D), dtype, device=device),
        "mix_ch": 0.5 * torch.ones(lead + (2, D), dtype=torch.float32,
                                   device=_device_of(gen, device)),            # r, k
    }


def init_model(gen, cfg: ModelConfig, device=None) -> Params:
    """Random parameters drawn from ``gen`` on its device (or only their
    shapes and dtypes with ``device="meta"``)."""
    dtype = torch_dtype(cfg.dtype)
    dev = _device_of(gen, device)
    L, D = cfg.num_layers, cfg.d_model
    return {
        "embed": {"w": embed_init(gen, (cfg.padded_vocab, D), dtype, device=device)},
        "blocks": {
            "ln1": {"w": torch.ones((L, D), dtype=dtype, device=dev)},
            "ln2": {"w": torch.ones((L, D), dtype=dtype, device=dev)},
            "rwkv": init_time_mix(gen, cfg, L, device=device),
            "cmix": init_channel_mix(gen, cfg, L, device=device),
        },
        "final_norm": {"w": torch.ones((D,), dtype=dtype, device=dev)},
        "lm_head": {"w": dense_init(gen, (D, cfg.padded_vocab), dtype, scale=0.02, device=device)},
    }


# ---------------------------------------------------------------------------
# WKV: chunked plain form (model layout) and the kernel behind autograd
# ---------------------------------------------------------------------------

def _tr(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)


def wkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """r, k, v, logw: (B, S, H, hd) f32 (logw <= 0); u: (H, hd); s0: (B, H,
    hd, hd).  Returns (y (B, S, H, hd), s_final): ``kernels.wkv.wkv_plain``
    seen in the model's layout."""
    y, s_final = wkv_plain(_tr(r), _tr(k), _tr(v), _tr(logw), u, s0, chunk)
    return _tr(y), s_final


class _WkvKernelFn(torch.autograd.Function):
    """Kernel forward with the chunked form's gradients (recomputed in
    backward): the counterpart of ``_wkv_pallas_cv``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        y, s_final = wkv(_tr(r), _tr(k), _tr(v), _tr(logw), u, s0, chunk)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.chunk = chunk
        return _tr(y), s_final

    @staticmethod
    def backward(ctx, g_y, g_s):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, s_final = wkv_chunked(*inputs, ctx.chunk)
        grads = torch.autograd.grad((y, s_final), inputs, (g_y, g_s), allow_unused=True)
        return (*grads, None)


def _wkv_any(r, k, v, logw, u, s0, chunk: int, kernel: bool):
    """The recurrence on the kernel or the chunked form; ``s0`` None: zeros."""
    if s0 is None:
        B, _, H, hd = r.shape
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if kernel:
        return _WkvKernelFn.apply(r, k, v, logw, u, s0, chunk)
    return wkv_chunked(r, k, v, logw, u, s0, chunk)


def _wkv_on_shards(r, k, v, logw, u, s0, chunk: int, kernel: bool):
    """``_wkv_any``; on DTensors each rank on its batch rows
    (``sharding.row_placements``) and, where the heads divide `model`, its
    heads (``sharding.on_shards``).  The recurrence is independent per (row,
    head); DTensor's own strategies for its batched products flatten (row,
    head) into one dim that the pod mesh shards three ways, and gather it
    whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(r, DTensor):
        return _wkv_any(r, k, v, logw, u, s0, chunk, kernel)
    mesh = r.device_mesh
    split = r.shape[2] % shd.mesh_axis_size(mesh, "model") == 0
    rows = shd.row_placements(mesh, r.shape[0])
    seq = shd.with_model(mesh, rows, Shard(2) if split else Replicate())      # (B, S, H, hd)
    st = shd.with_model(mesh, rows, Shard(1) if split else Replicate())       # (B, H, hd, hd)
    hu = shd.with_model(mesh, [Replicate()] * len(rows), Shard(0) if split else Replicate())
    if s0 is not None and not isinstance(s0, DTensor):     # a zero state the model built
        s0 = DTensor.from_local(s0, mesh, [Replicate()] * len(rows), run_check=False)
    fn = shd.on_shards(lambda r, k, v, w, u, s: _wkv_any(r, k, v, w, u, s, chunk, kernel), mesh,
                       (seq, seq, seq, seq, hu, st if s0 is not None else None), (seq, st))
    return fn(r, k, v, logw, u, s0)


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------

def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); prev: (B, D) last token of the previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _decay(params: Params, xw: torch.Tensor) -> torch.Tensor:
    lo = torch.tanh(shd.token_product(xw, params["w_decay_lora_a"]))
    lora = shd.constrain_rows(lo) @ params["w_decay_lora_b"]
    return -torch.exp(params["w_decay"] + lora.float())               # logw <= 0


def _group_norm(y: torch.Tensor, weight: torch.Tensor, H: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS norm over hd; y: (B, S, H, hd) f32."""
    B, S, _, hd = y.shape
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + eps)
    return y.reshape(B, S, H * hd) * weight


def time_mix(params: Params, x: torch.Tensor, cfg: ModelConfig,
             state: Optional[Dict[str, torch.Tensor]] = None):
    """x: (B, S, D) -> (out, {state, tm_x})."""
    B, S, D = x.shape
    H, hd = head_dims(cfg)
    prev = shd.constrain_stream(state["tm_x"]) if state is not None else x.new_zeros((B, D))
    xs = _token_shift(x, prev)
    mu = params["mix"].to(x.dtype)                                     # (5, D)
    mr, mk, mv, mw, mg = (x + mu[i] * (xs - x) for i in range(5))
    r = project(mr, params["w_r"]).reshape(B, S, H, hd).float()
    k = project(mk, params["w_k"]).reshape(B, S, H, hd).float()
    v = project(mv, params["w_v"]).reshape(B, S, H, hd).float()
    g = F.silu(project(mg, params["w_g"]))
    logw = _decay(params, mw).reshape(B, S, H, hd)
    u = params["u_bonus"].reshape(H, hd)
    s0 = state["state"] if state is not None else None
    y, s_final = _wkv_on_shards(r, k, v, logw, u, s0, cfg.ssm.chunk_size, use_pallas(cfg, x))
    y = _group_norm(y, params["ln_x"].float(), H)
    out = project(y.to(x.dtype) * g, params["w_o"])
    return out, {"state": s_final, "tm_x": x[:, -1]}


def _channel_products(mr, mk, wr, wk, wv) -> torch.Tensor:
    r = torch.sigmoid(mr @ wr)
    return r * (torch.square(torch.relu(mk @ wk)) @ wv)


def _channel_products_split(mr, mk, wr, wk, wv) -> torch.Tensor:
    """``_channel_products`` on DTensors whose tokens do not divide `model`
    (a decode step): the weights are whole over `model`, so each product
    splits its columns there, or its contraction where its input comes
    split (``sharding.linear``): r and the key path by their columns, the
    value product by its d_ff rows, a pending sum.  Where the rows are
    whole over `data` both factors are placed as the residual stream
    (``sharding.constrain_stream``); else the pending sum is
    reduce-scattered onto r's columns."""
    r = torch.sigmoid(shd.linear(mr, wr))
    kv = shd.linear(torch.square(torch.relu(shd.linear(mk, wk))), wv)
    if shd.rows_whole(mr):
        return shd.constrain_stream(r) * shd.constrain_stream(kv)
    return r * kv.redistribute(kv.device_mesh, r.placements)


def channel_mix(params: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None):
    B, S, D = x.shape
    prev = shd.constrain_stream(state["cm_x"]) if state is not None else x.new_zeros((B, D))
    xs = _token_shift(x, prev)
    mu = params["mix_ch"].to(x.dtype)
    mr, mk = (x + mu[i] * (xs - x) for i in range(2))
    weights = tuple(params[key] for key in ("wr_ch", "wk_ch", "wv_ch"))
    if shd.tokens_divide(mr):
        c = shd.on_tokens(_channel_products, (mr, mk), weights)
    else:
        c = _channel_products_split(mr, mk, *weights)
    return c, {"cm_x": x[:, -1]}


def _block(bp: Params, x: torch.Tensor, cfg: ModelConfig, state=None):
    tm_state = ({"state": state["state"], "tm_x": state["tm_x"]}
                if state is not None else None)
    a, tm_new = time_mix(bp["rwkv"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps), cfg, tm_state)
    x = x + shd.constrain_stream(a)
    cm_state = {"cm_x": state["cm_x"]} if state is not None else None
    c, cm_new = channel_mix(bp["cmix"], rms_norm(x, bp["ln2"]["w"], cfg.norm_eps), cm_state)
    return x + shd.constrain_stream(c), {**tm_new, **cm_new}


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            want_state: bool = False, state=None):
    """tokens: (B, S) int -> (hidden (B, S, D), stacked per-layer state or
    None).  A Python loop over the stacked layers (``lax.scan`` in JAX),
    each under ``torch.utils.checkpoint`` with ``cfg.remat`` while
    gradients are recorded."""
    x = shd.constrain_stream(lookup(params["embed"]["w"], tokens))
    if state is None:
        B = tokens.shape[0]
        H, hd = head_dims(cfg)
        L, D = cfg.num_layers, cfg.d_model
        state = {"state": torch.zeros((L, B, H, hd, hd), dtype=torch.float32, device=x.device),
                 "tm_x": x.new_zeros((L, B, D)),
                 "cm_x": x.new_zeros((L, B, D))}

    def body(h, lp, lst):
        return _block(lp, h, cfg, lst)

    new_states = []
    for i in range(cfg.num_layers):
        lp = tree_map(lambda p: p[i], params["blocks"])
        lst = {key: val[i] for key, val in state.items()}
        if cfg.remat and torch.is_grad_enabled():
            x, ns = checkpoint(body, x, lp, lst, use_reentrant=False, preserve_rng_state=False)
        else:
            x, ns = body(x, lp, lst)
        if want_state:
            new_states.append(ns)
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    new_state = ({key: torch.stack([ns[key] for ns in new_states]) for key in state}
                 if want_state else None)
    return x, new_state


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    x, _ = forward(params, batch["tokens"], cfg)
    xent = chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                cfg.logit_chunk, valid_vocab=cfg.vocab_size)
    return xent, {"xent": xent}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    x, state = forward(params, tokens, cfg, want_state=True)
    logits = x[:, -1:] @ params["lm_head"]["w"]
    return logits, state


def decode_step(params: Params, token: torch.Tensor, cache, cache_index, cfg: ModelConfig):
    """token: (B, 1).  The recurrent state is O(1) in sequence length:
    ``cache_index`` is unused (kept for API uniformity)."""
    x, new_state = forward(params, token, cfg, want_state=True, state=cache)
    logits = project(x[:, -1:], params["lm_head"]["w"])
    return logits, new_state


def cache_spec(cfg: ModelConfig, batch: int):
    H, hd = head_dims(cfg)
    L, D = cfg.num_layers, cfg.d_model
    dtype = torch_dtype(cfg.dtype)
    return {"state": ((L, batch, H, hd, hd), torch.float32),
            "tm_x": ((L, batch, D), dtype),
            "cm_x": ((L, batch, D), dtype)}
