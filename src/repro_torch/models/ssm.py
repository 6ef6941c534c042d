"""Mamba2 (SSD, state-space duality) mixer block [arXiv:2405.21060] (port of
``repro.models.ssm``).

Recurrence per head (state N, head dim P):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · h_t + D_skip * x_t

Prefill uses the chunked SSD form: intra-chunk contributions through the
masked decay matrix L = exp(segsum(a)) (quadratic only within a chunk), and
chunk states carried from chunk to chunk by a loop over the chunks (the
reference's ``lax.scan``).  Decode is the O(1)-per-token recurrence on a
persistent (H, P, N) state.  Every product is f32, as in the reference.

The chunked and sequential paths agree to about 1e-4 (f32 sums in other
orders).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .layers import Params, _matmul, normal
from .mlp import _silu


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, k-1, conv_channels) — causal conv tail
    ssm: torch.Tensor     # (B, H, P, N) f32 — recurrent state


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_headdim
    H = d_inner // P
    N = cfg.ssm_state
    G = 1
    return d_inner, H, P, N, G


def init_ssm(cfg, gen, device) -> Params:
    dt = getattr(torch, cfg.dtype)
    d_inner, H, P, N, G = _dims(cfg)
    conv_ch = d_inner + 2 * G * N
    in_dim = 2 * d_inner + 2 * G * N + H

    def f32(value):
        return torch.full((H,), value, dtype=torch.float32, device=device)

    return {
        "w_in": normal(gen, (cfg.d_model, in_dim), cfg.d_model ** -0.5,
                       device, dt),
        "conv_w": normal(gen, (cfg.ssm_conv, conv_ch), 0.2, device, dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": f32(0.0),                       # A = -exp(A_log) = -1
        "D_skip": f32(1.0),
        "dt_bias": f32(0.0),
        "norm_scale": torch.ones((d_inner,), dtype=torch.float32,
                                 device=device),
        "w_out": normal(gen, (d_inner, cfg.d_model), d_inner ** -0.5,
                        device, dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None,
                 lengths: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C), w: (k, C).  Returns
    (silu(y), new_tail).

    The k taps are summed in f32 and rounded once to x's dtype, as the
    reference's einsum.  ``lengths`` (B,) marks ragged rows right-padded to
    S: the returned tail is then each row's last k-1 valid inputs (a per-row
    gather into ``concat([tail, x])``), so pad columns never enter a row's
    carried window; a length-0 row keeps its incoming tail.
    """
    k = w.shape[0]
    B, S, C = x.shape
    if tail is None:
        tail = torch.zeros((B, k - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)          # (B, S+k-1, C)
    wf = w.to(torch.float32)
    acc = xp[:, 0:S].to(torch.float32) * wf[0]
    for j in range(1, k):
        acc = acc + xp[:, j:j + S].to(torch.float32) * wf[j]
    y = acc.to(x.dtype) + b
    if lengths is None:
        new_tail = xp[:, xp.shape[1] - (k - 1):]
    else:
        # xp index of position t is t + (k-1); the window of k-1 inputs
        # ending at a row's last valid one starts at index L
        tidx = lengths[:, None].to(torch.int64) \
            + torch.arange(k - 1, device=x.device)[None]
        new_tail = torch.gather(xp, 1, tidx[..., None].expand(B, k - 1, C))
    return _silu(y), new_tail


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log decays -> (..., Q, Q) with S[i, j] = sum_{j<m<=i}
    a_m, -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    S = cs[..., :, None] - cs[..., None, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(tri, S, -torch.inf)


def ssd_chunked(x, dtv, A, B, C, chunk: int, init_state=None):
    """Chunked SSD.  x: (b, s, h, p), dtv: (b, s, h), A: (h,), B, C:
    (b, s, n) [one group].  Returns y: (b, s, h, p) f32 and the final state
    (b, h, p, n) f32."""
    b, s, h, pdim = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        def padded(t):
            return torch.nn.functional.pad(
                t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dtv, B, C = padded(x), padded(dtv), padded(B), padded(C)
    f32 = torch.float32
    a = (dtv * A[None, None, :]).to(f32)                  # (b, s', h)
    xc = x.reshape(b, nc, q, h, pdim).to(f32)
    dc = dtv.reshape(b, nc, q, h).to(f32).transpose(2, 3)  # (b, nc, h, q)
    ac = a.reshape(b, nc, q, h).transpose(2, 3)           # (b, nc, h, q)
    Bc = B.reshape(b, nc, q, n).to(f32)
    Cc = C.reshape(b, nc, q, n).to(f32)
    xh = xc.permute(0, 1, 3, 2, 4)                        # (b, nc, h, q, p)

    cs = torch.cumsum(ac, dim=-1)                         # inclusive
    L = torch.exp(_segsum(ac))                            # (b, nc, h, q, q)

    # intra-chunk: y_i += sum_{j<=i} C_i·B_j L[i, j] dt_j x_j
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))       # (b, nc, q, q)
    w = scores[:, :, None] * L * dc[..., None, :]
    y_intra = torch.matmul(w, xh)                         # (b, nc, h, q, p)

    # chunk states: sum_j decay_to_end[j] dt_j x_j ⊗ B_j -> (b, nc, h, p, n)
    decay_end = torch.exp(cs[..., -1:] - cs)              # (b, nc, h, q)
    states = torch.matmul((xh * (decay_end * dc)[..., None]).transpose(-1, -2),
                          Bc[:, :, None])

    # inter-chunk recurrence over the chunks
    T = torch.exp(cs[..., -1])                            # (b, nc, h)
    hcur = torch.zeros((b, h, pdim, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = T[:, c, :, None, None] * hcur + states[:, c]
    hprev = torch.stack(hprevs, dim=1)                    # (b, nc, h, p, n)

    # inter-chunk output: y_i += C_i · decay_in[i] · h_prev
    decay_in = torch.exp(cs)                              # includes a_i
    y_inter = torch.matmul(Cc[:, :, None], hprev.transpose(-1, -2)) \
        * decay_in[..., None]                             # (b, nc, h, q, p)

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, nc * q, h, pdim)
    return y[:, :s], hcur


def ssd_sequential(x, dtv, A, B, C, init_state=None):
    """The O(S) sequential recurrence, one step per token: the oracle for
    tests and the decode step."""
    b, s, h, pdim = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    hcur = torch.zeros((b, h, pdim, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    x, dtv, B, C = (t.to(f32) for t in (x, dtv, B, C))
    ys = []
    for t in range(s):
        at = torch.exp(dtv[:, t] * A)                     # (b, h)
        upd = (dtv[:, t, :, None] * x[:, t])[..., None] \
            * B[:, t, None, None, :]                      # (b, h, p, n)
        hcur = at[..., None, None] * hcur + upd
        ys.append(torch.matmul(hcur, C[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), hcur


def apply_ssm(p: Params, x: torch.Tensor, cfg,
              state: SSMState | None = None, return_state: bool = False,
              sequential: bool = False,
              q_valid: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, SSMState | None]:
    """Full mamba2 mixer.  x: (B, S, d_model).

    ``q_valid`` (B, S) bool marks ragged rows right-padded to S.  Pad
    positions are exact identity steps of the recurrence (``dt = 0``: decay
    exp(0) = 1 and a zero update, in the sequential and the chunked path),
    and the conv tail gathers each row's last valid inputs, so carried state
    advances only past real tokens.  Pad rows' outputs are garbage.
    """
    B_, S, _ = x.shape
    d_inner, H, P, N, G = _dims(cfg)
    zxbcdt = _matmul(x, p["w_in"], x.dtype)
    z, xBC, dt_raw = torch.split(
        zxbcdt, [d_inner, d_inner + 2 * G * N, H], dim=-1)

    lengths = None if q_valid is None \
        else q_valid.to(torch.int32).sum(dim=1)
    conv_tail = state.conv if state is not None else None
    xBC, new_tail = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_tail,
                                 lengths=lengths)
    x_ssm, Bmat, Cmat = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)

    dtv = softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    if q_valid is not None:
        dtv = torch.where(q_valid[..., None], dtv, 0.0)
    A = -torch.exp(p["A_log"])
    xh = x_ssm.reshape(B_, S, H, P)

    init = state.ssm if state is not None else None
    if sequential or S == 1:
        y, hfin = ssd_sequential(xh, dtv, A, Bmat, Cmat, init_state=init)
    else:
        y, hfin = ssd_chunked(xh, dtv, A, Bmat, Cmat, cfg.ssm_chunk,
                              init_state=init)
    y = y + p["D_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(B_, S, d_inner)

    # gated RMSNorm (mamba2): norm(y * silu(z)) * scale
    g = y * _silu(z.to(torch.float32))
    r = torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + 1e-6)
    g = (g * r * p["norm_scale"]).to(x.dtype)

    out = _matmul(g, p["w_out"], g.dtype)
    new_state = SSMState(conv=new_tail, ssm=hfin) if return_state else None
    return out, new_state
