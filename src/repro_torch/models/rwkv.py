"""RWKV-6 "Finch": attention-free time-mix with data-dependent decay.

Counterpart of ``repro/models/rwkv.py``.  The WKV recurrence per head
(state S in R^{hd x hd}):

    y_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(-exp(w0 + lora(x)))

Kernel dispatch differs from the reference on purpose.  JAX sends a WKV
call to its Pallas kernel only for ``S > 1`` and ``S % chunk_size == 0``,
and everything else (every ``S = 1`` decode step) to the chunked jnp form,
because its kernel walks whole chunks.  The port's kernel
(``repro_torch.kernels.wkv``) runs the recurrence one step at a time and
takes any S, so on a CUDA tensor, with ``use_pallas`` not ``never``,
*every* WKV call goes through it, decode included: no plain code on the
card's serving path.  The kernel reads the model's (B, S, H, hd) tensors
through their strides (no transposes).  Its gradient is the chunked
form's, recomputed in backward, as ``_wkv_pallas_cv`` does in JAX.

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
                                       embed_init, rms_norm, torch_dtype)
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


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------

def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); prev: (B, D) last token of the previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _decay(params: Params, xw: torch.Tensor) -> torch.Tensor:
    lora = torch.tanh(xw @ params["w_decay_lora_a"]) @ params["w_decay_lora_b"]
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
    prev = state["tm_x"] if state is not None else x.new_zeros((B, D))
    xs = _token_shift(x, prev)
    mu = params["mix"].to(x.dtype)                                     # (5, D)
    mr, mk, mv, mw, mg = (x + mu[i] * (xs - x) for i in range(5))
    r = (mr @ params["w_r"]).reshape(B, S, H, hd).float()
    k = (mk @ params["w_k"]).reshape(B, S, H, hd).float()
    v = (mv @ params["w_v"]).reshape(B, S, H, hd).float()
    g = F.silu(mg @ params["w_g"])
    logw = _decay(params, mw).reshape(B, S, H, hd)
    u = params["u_bonus"].reshape(H, hd)
    s0 = (state["state"] if state is not None
          else torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device))
    if use_pallas(cfg, x):
        y, s_final = _WkvKernelFn.apply(r, k, v, logw, u, s0, cfg.ssm.chunk_size)
    else:
        y, s_final = wkv_chunked(r, k, v, logw, u, s0, cfg.ssm.chunk_size)
    y = _group_norm(y, params["ln_x"].float(), H)
    out = (y.to(x.dtype) * g) @ params["w_o"]
    return out, {"state": s_final, "tm_x": x[:, -1]}


def channel_mix(params: Params, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None):
    B, S, D = x.shape
    prev = state["cm_x"] if state is not None else x.new_zeros((B, D))
    xs = _token_shift(x, prev)
    mu = params["mix_ch"].to(x.dtype)
    mr, mk = (x + mu[i] * (xs - x) for i in range(2))
    r = torch.sigmoid(mr @ params["wr_ch"])
    kk = torch.square(torch.relu(mk @ params["wk_ch"]))
    return r * (kk @ params["wv_ch"]), {"cm_x": x[:, -1]}


def _block(bp: Params, x: torch.Tensor, cfg: ModelConfig, state=None):
    tm_state = ({"state": state["state"], "tm_x": state["tm_x"]}
                if state is not None else None)
    a, tm_new = time_mix(bp["rwkv"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps), cfg, tm_state)
    x = x + a
    cm_state = {"cm_x": state["cm_x"]} if state is not None else None
    c, cm_new = channel_mix(bp["cmix"], rms_norm(x, bp["ln2"]["w"], cfg.norm_eps), cm_state)
    return x + c, {**tm_new, **cm_new}


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            want_state: bool = False, state=None):
    """tokens: (B, S) int -> (hidden (B, S, D), stacked per-layer state or
    None).  A Python loop over the stacked layers (``lax.scan`` in JAX),
    each under ``torch.utils.checkpoint`` with ``cfg.remat`` while
    gradients are recorded."""
    x = params["embed"]["w"][tokens.long()]
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
    logits = x[:, -1:] @ params["lm_head"]["w"]
    return logits, new_state


def cache_spec(cfg: ModelConfig, batch: int):
    H, hd = head_dims(cfg)
    L, D = cfg.num_layers, cfg.d_model
    dtype = torch_dtype(cfg.dtype)
    return {"state": ((L, batch, H, hd, hd), torch.float32),
            "tm_x": ((L, batch, D), dtype),
            "cm_x": ((L, batch, D), dtype)}
