"""Plain torch version of the RWKV6 wkv recurrence, in the model's layout.

Counterpart of ``repro.models.rwkv6.wkv_chunked`` (the chunked form the
Pallas kernel implements): r, k, v, logw (B, T, H, D); u (H, D); an optional
input state s0 (B, H, Dk, Dv).  Per head,

    S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)

computed in float32 over chunks of ``CHUNK`` tokens: a Python loop over the
chunks, exponents centred at the chunk midpoint, strict-lower intra-chunk
scores, the ``u`` bonus and cross = (r . exp(la_prev)) @ S.  Returns y
(B, T, H, D) and the final S (B, H, D, D), both float32.

Any T is exact: the tail past T is filled with logw = 0 and k = v = 0, so
it adds nothing to S and decays nothing (the JAX package pads logw with
-1e-4, which decays the returned S; ROADMAP Queue 3).  It is the CPU path
of the wrapper and the version the CUDA kernel is held to on the card.
``rwkv6_scan_step_ref`` is the per-token recurrence, and
``rwkv6_scan_segmented_ref`` the CUDA kernel's decomposition of the time axis,
for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 16


def rwkv6_scan_ref(r, k, v, logw, u, s0=None):
    b, t, h, d = r.shape
    c = CHUNK
    pad = (-t) % c
    n = (t + pad) // c

    def chunks(a):  # (B, T, H, D) -> (n, B, C, H, D) float32, tail zero-filled
        return F.pad(a.float(), (0, 0, 0, 0, 0, pad)).reshape(b, n, c, h, d).transpose(0, 1)

    rc, kc, vc, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    u = u.float()
    la = torch.cumsum(lw, dim=2)                   # inclusive within chunk
    la_prev = la - lw
    mid = la[:, :, c // 2:c // 2 + 1]              # centering constant
    qq = rc * torch.exp(la_prev - mid)
    kk = kc * torch.exp(mid - la)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)

    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) if s0 is None
         else s0.float().clone())
    y = torch.empty((n, b, c, h, d), dtype=torch.float32, device=r.device)
    for i in range(n):
        scores = torch.einsum("bthd,bshd->bhts", qq[i], kk[i]).masked_fill(~mask, 0.0)
        intra = torch.einsum("bhts,bshd->bthd", scores, vc[i])
        bonus = torch.einsum("bthd,hd,bthd->bth", rc[i], u, kc[i])
        cross = torch.einsum("bthd,bhdv->bthv", rc[i] * torch.exp(la_prev[i]), S)
        y[i] = intra + bonus[..., None] * vc[i] + cross
        last = la[i][:, -1]                        # (B, H, D)
        kdec = kc[i] * torch.exp(last[:, None] - la[i])
        S = torch.exp(last)[..., None] * S + torch.einsum("bthd,bthv->bhdv", kdec, vc[i])
    return y.transpose(0, 1).reshape(b, n * c, h, d)[:, :t], S


def rwkv6_scan_step_ref(r, k, v, logw, u, s0=None):
    """The recurrence one token at a time (the oracle ``rwkv6_scan_ref`` of
    the JAX package), same layout and results as ``rwkv6_scan_ref``."""
    b, t, h, d = r.shape
    r, k, v, w = r.float(), k.float(), v.float(), logw.float()
    u = u.float()
    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) if s0 is None
         else s0.float().clone())
    ys = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]          # (B, H, Dk, Dv)
        ys.append(torch.einsum("bhd,bhdv->bhv", r[:, i], S + u[..., None] * kv))
        S = torch.exp(w[:, i])[..., None] * S + kv
    return torch.stack(ys, 1), S


def rwkv6_scan_segmented_ref(r, k, v, logw, u, s0=None, seg: int = 256):
    """The kernel's decomposition in plain torch, same layout and results as
    ``rwkv6_scan_ref``: the time axis in segments of ``seg`` tokens (a multiple of
    CHUNK); each segment but the last runs the chunk recurrence from a zero state
    to its local end state S_loc(j), with its decay W_j = exp(sum of its logw);
    S_in(0) = s0, S_in(j + 1) = diag(W_j) S_in(j) + S_loc(j); then each segment's
    outputs from S_in(j), and the last segment's end state is the final S."""
    if seg < CHUNK or seg % CHUNK:
        raise ValueError(f"seg must be a positive multiple of {CHUNK}, got {seg}")
    b, t, h, d = r.shape
    bounds = [(j, min(j + seg, t)) for j in range(0, t, seg)]
    s_in = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) if s0 is None
            else s0.float())
    states = [s_in]
    for lo, hi in bounds[:-1]:
        _, s_loc = rwkv6_scan_ref(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi], logw[:, lo:hi], u)
        decay = torch.exp(logw[:, lo:hi].float().sum(1))                # (B, H, D)
        states.append(decay[..., None] * states[-1] + s_loc)
    ys = []
    for (lo, hi), s_in in zip(bounds, states):
        y, s = rwkv6_scan_ref(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi], logw[:, lo:hi], u, s_in)
        ys.append(y)
    return torch.cat(ys, 1), s
