"""RWKV-6 WKV recurrence: per head, with an (hd x hd) state S,

    y_t = r_t (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(logw_t), logw_t <= 0

Counterpart of ``repro/kernels/wkv.py`` (``wkv_pallas``), with its
``(B, H, S, hd)`` signature.  ``wkv_plain`` is the port's one copy of the
chunked form of ``repro.models.rwkv.wkv_chunked`` (an intra-chunk
decay-weighted attention plus a carried state; the pairwise decay is
clipped at exp(-60), where the true value underflows anyway).

On a CUDA tensor ``wkv`` takes one of two hand-written kernels, both of
which ignore ``chunk`` and read their inputs through their strides (unit
stride along hd), so a transposed view costs no copy:

- the chunked route, ``csrc/wkv_sm90.cu``, for S >= 64 and hd 16 or 64
  (rwkv6-1.6b's prefill and trainer): chunks of 64 steps whose products run
  on the tensor cores in 3xTF32, the state carried on chip;
- the step route, ``csrc/wkv.cu``, for every other shape (hd a multiple of
  8 up to 128), the S = 1 of a decode step among them: the recurrence
  itself, one step at a time.

The tracer's counter ``launch.wkv`` (``utils/trace``) counts the launches
of both, ``route.wkv_chunked`` those of the chunked route.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.utils import trace

MAX_HEAD_DIM = 128
CHUNK = 64                      # steps a chunk of the chunked route
CHUNKED_HEAD_DIMS = (16, 64)    # head dims the chunked route is built for
BLOCKS_IN_FLIGHT = 128          # the chunked route splits the value columns until this many


def chunked_route(S: int, hd: int) -> bool:
    """Whether a CUDA call of this shape takes the chunked kernel."""
    return S >= CHUNK and hd in CHUNKED_HEAD_DIMS


def value_columns(B: int, H: int, hd: int) -> int:
    """The value columns one block of the chunked kernel owns: all hd of
    them, halved (down to 16) while fewer than ``BLOCKS_IN_FLIGHT`` blocks
    would run."""
    ev = hd
    while ev > 16 and B * H * (hd // ev) < BLOCKS_IN_FLIGHT:
        ev //= 2
    return ev


def wkv_plain(r, k, v, logw, u, s0, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, H, S, hd) f32 (logw <= 0); u: (H, hd); s0: (B, H,
    hd, hd).  Returns (y (B, H, S, hd), s_final (B, H, hd, hd)).  Chunks of
    ``chunk`` steps (one chunk of S when S % chunk != 0), f32, differentiable."""
    B, H, S, hd = r.shape
    if S % chunk != 0:
        chunk = S
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=r.device).tril(-1)   # j < t
    uu = u[None, :, None, :]
    s = s0
    ys = []
    for c0 in range(0, S, chunk):
        rr, kk, vv, ww = (t[:, :, c0:c0 + chunk] for t in (r, k, v, logw))
        L = torch.cumsum(ww, dim=2)                     # inclusive
        Lx = L - ww                                     # exclusive
        # pairwise decay exp(Lx[t] - L[j]) <= 1 for j < t: (B, H, t, j, hd)
        dec = torch.exp(torch.clamp(Lx[:, :, :, None, :] - L[:, :, None, :, :], -60.0, 0.0))
        scores = torch.einsum("bhtjd,bhjd->bhtj", dec * rr[:, :, :, None, :], kk) * tri
        diag = (rr * uu * kk).sum(-1, keepdim=True)     # (B, H, C, 1)
        y = scores @ vv + diag * vv + (rr * torch.exp(Lx)) @ s
        k_dec = kk * torch.exp(L[:, :, -1:] - L)        # exp <= 1
        s = s * torch.exp(L[:, :, -1])[..., None] + k_dec.transpose(-1, -2) @ vv
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=2)), s


def _check(r, k, v, logw, u, s0) -> None:
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape:
        raise ValueError(f"r, k, v, logw must share one (B, H, S, hd) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, H, S, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"u must be {(H, hd)} and s0 {(B, H, hd, hd)}, got "
                         f"{tuple(u.shape)} and {tuple(s0.shape)}")
    if any(t.dtype != torch.float32 for t in (r, k, v, logw, u, s0)):
        raise ValueError("wkv takes float32 tensors")


def wkv(r, k, v, logw, u, s0, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence with ``wkv_pallas``'s signature (see
    ``wkv_plain``): the plain version on CPU tensors; on CUDA tensors the
    chunked kernel where ``chunked_route`` says so, else the step kernel
    (``hd`` a multiple of 8 up to 128).  On the card, y comes back with r's
    strides."""
    _check(r, k, v, logw, u, s0)
    if not r.is_cuda:
        return wkv_plain(r, k, v, logw, u, s0, chunk)
    B, H, S, hd = r.shape
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    if any(t.device != r.device for t in (k, v, logw, u, s0)):
        raise ValueError("all inputs must lie on one device")
    # the kernel reads all four through r's strides and writes y with them:
    # (B, H, S, hd) or the model's (B, S, H, hd) seen through a transpose
    dense = r.is_contiguous() or r.transpose(1, 2).is_contiguous()
    chunked = chunked_route(S, hd)
    # the chunked kernel moves 16-byte pieces: strides in whole pieces, aligned data
    aligned = all(t.data_ptr() % 16 == 0 for t in (r, k, v, logw)) and all(
        x % 4 == 0 for x in r.stride()[:3])
    if (not dense or any(t.stride() != r.stride() for t in (k, v, logw))
            or (chunked and not aligned)):
        r, k, v, logw = (t.contiguous() for t in (r, k, v, logw))
    u, s0 = u.contiguous(), s0.contiguous()
    lib = build.library()
    y = torch.empty_strided(r.shape, r.stride(), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(s0)
    sb, sh, st, _ = r.stride()
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_out.data_ptr())
    with torch.cuda.device(r.device):
        stream = build.current_stream(r.device)
        if chunked:
            name = "repro_wkv_chunked_f32"
            code = lib.repro_wkv_chunked_f32(*ptrs, B, H, S, hd, value_columns(B, H, hd),
                                             sb, sh, st, stream)
        else:
            name = "repro_wkv_f32"
            code = lib.repro_wkv_f32(*ptrs, B, H, S, hd, sb, sh, st, stream)
    build.check(code, name)
    trace.count("launch.wkv")
    if chunked:
        trace.count("route.wkv_chunked")
    return y, s_out
