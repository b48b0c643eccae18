"""Chunked gated linear attention (GLA) — the port of `repro.models.gla`:
the shared engine of Mamba2 (SSD) and xLSTM's mLSTM, and the sLSTM
recurrent cell.

Recurrence (per batch, head):   S_t = a_t · S_{t-1} + k_t ⊗ v_t
Output:                          y_t = S_t^T q_t
with a_t = exp(g_t), g_t ≤ 0. The chunked form (chunk length cl) computes
an intra-chunk quadratic term (L ∘ (Q Kᵀ)) V and carries the (N, P)
state across chunks. The reference scans the chunks with `lax.scan`;
here the terms that need no state (the intra-chunk product and each
chunk's state increment) are batched over all chunks, and a Python loop
carries the state, chunk by chunk, in the reference's order. The sLSTM
time loop is a Python loop over tokens. Everything is plain PyTorch, as
the reference is plain `jnp`: no kernel is launched here.

Numerics are the reference's: decay factors exp(cum_t − cum_j) with
j ≤ t (≤ 1 since g ≤ 0), masked BEFORE the exp (a masked entry would
overflow and give 0·inf = NaN in the backward); log-sigmoid-bounded
gates; fp32 states; the bf16 rounding points of the reference's jaxpr
(the per-chunk output cast to v's dtype, bf16 products where the
reference multiplies in the compute dtype, Python constants rounded to
the operand's dtype as jax's weak types round them). Where the math has
a kink the reference's derivative is kept: |x| has derivative +1 at 0
and max(a, b) splits a tie (`torch.maximum`, not `clamp`); softplus is
`logaddexp(x, 0)` (torch's `softplus` turns linear past 20).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (_silu, _splittable, rmsnorm,
                                       spec_rmsnorm)
from repro_torch.models.spec import TensorSpec


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0), values and gradients."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jax's derivative (+1 at 0; torch's `abs` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _max1(x: torch.Tensor) -> torch.Tensor:
    """max(x, 1), a tie's gradient split as `jnp.maximum` splits it."""
    return torch.maximum(x, x.new_ones(()))


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as jax's weak typing sees it: rounded to the
    operand's dtype."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ----------------------------------------------------------------------
# chunked GLA core
# ----------------------------------------------------------------------
def gla_chunked(q, k, v, g, state, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, S, H, N); v: (B, S, H, P); g: (B, S, H) log-decay ≤ 0;
    state: (B, H, N, P) incoming. Returns (y (B, S, H, P) in v's dtype,
    state_out fp32)."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    cl = min(chunk, S)
    pad = (-S) % cl
    if pad:
        def zf(x):
            return torch.cat([x, x.new_zeros((B, pad) + x.shape[2:])], 1)
        q, k, v, g = zf(q), zf(k), zf(v), zf(g)
    nc = q.shape[1] // cl

    def resh(x):                                 # (B, nc, cl, ...)
        return x.reshape((B, nc, cl) + x.shape[2:])
    qc, kc, vc, gc = (resh(x).float() for x in (q, k, v, g))

    cum = torch.cumsum(gc, dim=2)                # (B, nc, cl, H)
    cum_h = cum.transpose(2, 3)                  # (B, nc, H, cl)
    total = cum_h[..., -1]                       # (B, nc, H)

    # intra-chunk: A_tj = (q_t·k_j)·exp(cum_t − cum_j), j ≤ t
    qk = torch.einsum("bclhn,bcmhn->bchlm", qc, kc)
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    tri = torch.ones((cl, cl), dtype=torch.bool, device=q.device).tril()
    dmat = torch.exp(diff.masked_fill(~tri, NEG_INF))
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", qk * dmat, vc)

    # each chunk's state increment: Σ_j exp(total − cum_j) k_j ⊗ v_j
    k_hat = kc * torch.exp(total[:, :, None, :] - cum)[..., None]
    incr = torch.einsum("bclhn,bclhp->bchnp", k_hat, vc)
    decay = torch.exp(total)[..., None, None]    # (B, nc, H, 1, 1)

    # the carried state: S_in of chunk c, and the state after the last
    s = state.float()
    states = []
    for c in range(nc):
        states.append(s)
        s = s * decay[:, c] + incr[:, c]
    s_in = torch.stack(states, 1)                # (B, nc, H, N, P)

    # inter-chunk: y_t += exp(cum_t) · q_t S_in
    y_inter = torch.einsum("bclhn,bchnp->bclhp", qc, s_in) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).to(v.dtype).reshape(B, nc * cl, H, P)
    return y[:, :S], s


def gla_step(q, k, v, g, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. q, k: (B, H, N); v: (B, H, P); g: (B, H);
    state (B, H, N, P) fp32. Returns (y (B, H, P), new_state)."""
    a = torch.exp(g.float())[..., None, None]
    state = state * a + torch.einsum("bhn,bhp->bhnp", k.float(), v.float())
    y = torch.einsum("bhn,bhnp->bhp", q.float(), state)
    return y.to(v.dtype), state


# ----------------------------------------------------------------------
# causal depthwise conv (mamba2 / mlstm front-end), width W
# ----------------------------------------------------------------------
def causal_conv(x, w_conv, conv_state=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, C); w_conv: (W, C) depthwise taps. Without a state the
    input is left-padded with zeros (prefill, training); with
    conv_state (B, W-1, C) it continues from those inputs (decode).
    Returns (out, the last W-1 inputs: the next conv state)."""
    W = w_conv.shape[0]
    if conv_state is None:
        xp = torch.cat([x.new_zeros((x.shape[0], W - 1, x.shape[2])), x], 1)
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], 1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w_conv[i].to(x.dtype) for i in range(W))
    new_state = xp[:, xp.shape[1] - (W - 1):] if W > 1 else None
    return out, new_state


# ----------------------------------------------------------------------
# Mamba2 block (SSD)
# ----------------------------------------------------------------------
def spec_mamba2(cfg: ArchConfig) -> Dict:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    return {
        "norm": spec_rmsnorm(d),
        "in_proj": TensorSpec((d, 2 * di + 2 * N + H), ("embed", "ssm_in"),
                              init="normal", scale=d ** -0.5),
        "conv_w": TensorSpec((cfg.ssm_conv, conv_ch), (None, "ssm_in"),
                             init="normal", scale=0.1),
        "A_log": TensorSpec((H,), ("ssm_heads",), init="zeros"),
        "D": TensorSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": TensorSpec((H,), ("ssm_heads",), init="zeros"),
        "out_norm": spec_rmsnorm(di),
        "out_proj": TensorSpec((di, d), ("ssm_in", "embed"), init="normal",
                               scale=di ** -0.5),
    }


def mamba2_cache_spec(cfg: ArchConfig, batch: int) -> Dict:
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv": TensorSpec((batch, cfg.ssm_conv - 1, di + 2 * N),
                           ("batch", None, "ssm_in"), init="zeros",
                           dtype=cfg.dtype),
        "ssd": TensorSpec((batch, H, N, P), ("batch", "ssm_heads", None,
                                             None), init="zeros",
                          dtype=torch.float32),
    }


def _mamba2_project(params, cfg: ArchConfig, x):
    di, N = cfg.d_inner, cfg.ssm_state
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    zxbcdt = h @ params["in_proj"].to(h.dtype)
    return torch.split(zxbcdt, [di, di + 2 * N, cfg.ssm_heads], dim=-1)


def _mamba2_ssd_inputs(cfg: ArchConfig, params, xbc_conv, dt_pre):
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x, Bmat, Cmat = torch.split(xbc_conv, [di, N, N], dim=-1)
    lead = tuple(x.shape[:-1])
    xh = _splittable(x, -1, H).reshape(lead + (H, P))
    dt = _softplus(dt_pre.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())                  # (H,) < 0
    g = dt * a                                               # log decay ≤ 0
    v = xh * dt[..., None].to(xh.dtype)
    # B/C shared across heads (ngroups=1): broadcast
    k = Bmat[..., None, :].expand(lead + (H, N))
    q = Cmat[..., None, :].expand(lead + (H, N))
    return q, k, v, g, xh


def mamba2_apply(params, cfg: ArchConfig, x, cache=None, decode=False
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). Returns (y, new_cache): the new conv state (in the
    compute dtype) and SSD state, None without a cache. Prefill starts
    from the cache's SSD state and a zero conv history, as the
    reference's does."""
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_pre = _mamba2_project(params, cfg, x)
    xbc_c, conv_state = causal_conv(xbc, params["conv_w"],
                                    cache["conv"] if decode else None)
    xbc_c = _silu(xbc_c)
    q, k, v, g, xh = _mamba2_ssd_inputs(cfg, params, xbc_c, dt_pre)
    if decode:
        y, ssd = gla_step(q[:, 0], k[:, 0], v[:, 0], g[:, 0], cache["ssd"])
        y = y[:, None]
    else:
        state0 = x.new_zeros((x.shape[0], H, cfg.ssm_state, P),
                             dtype=torch.float32) \
            if cache is None else cache["ssd"]
        y, ssd = gla_chunked(q, k, v, g, state0, cfg.ssm_chunk)
    y = y + params["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(x.shape[0], -1, di)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * _silu(z)
    out = y @ params["out_proj"].to(y.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": conv_state.to(cfg.dtype), "ssd": ssd}
    return out, new_cache


# ----------------------------------------------------------------------
# mLSTM block (xLSTM matrix cell)
# ----------------------------------------------------------------------
def spec_mlstm(cfg: ArchConfig) -> Dict:
    d, di = cfg.d_model, cfg.lstm_inner
    H = cfg.num_heads
    return {
        "norm": spec_rmsnorm(d),
        "up_proj": TensorSpec((d, 2 * di), ("embed", "lstm_in"),
                              init="normal", scale=d ** -0.5),
        "conv_w": TensorSpec((cfg.lstm_conv, di), (None, "lstm_in"),
                             init="normal", scale=0.1),
        "wq": TensorSpec((di, di), ("lstm_in", "lstm_in2"), init="normal",
                         scale=di ** -0.5),
        "wk": TensorSpec((di, di), ("lstm_in", "lstm_in2"), init="normal",
                         scale=di ** -0.5),
        "wv": TensorSpec((di, di), ("lstm_in", "lstm_in2"), init="normal",
                         scale=di ** -0.5),
        "w_gates": TensorSpec((di, 2 * H), ("lstm_in", None), init="zeros"),
        "b_gates": TensorSpec((2 * H,), (None,), init="zeros"),
        "out_norm": spec_rmsnorm(di),
        "down_proj": TensorSpec((di, d), ("lstm_in", "embed"),
                                init="normal", scale=di ** -0.5),
    }


def mlstm_cache_spec(cfg: ArchConfig, batch: int) -> Dict:
    H, N, P = cfg.num_heads, cfg.lstm_head_qk, cfg.lstm_head_v
    return {
        "conv": TensorSpec((batch, cfg.lstm_conv - 1, cfg.lstm_inner),
                           ("batch", None, "lstm_in"), init="zeros",
                           dtype=cfg.dtype),
        # value dim augmented with the normalizer channel (+1)
        "S": TensorSpec((batch, H, N, P + 1), ("batch", "lstm_heads", None,
                                               None), init="zeros",
                        dtype=torch.float32),
    }


def _mlstm_qkvg(params, cfg: ArchConfig, x_in, conv_state):
    B = x_in.shape[0]
    H = cfg.num_heads
    N, P = cfg.lstm_head_qk, cfg.lstm_head_v
    up = x_in @ params["up_proj"].to(x_in.dtype)
    xm, zg = torch.chunk(up, 2, dim=-1)
    xc, new_conv = causal_conv(xm, params["conv_w"], conv_state)
    xc = _silu(xc)
    S = xc.shape[1]
    q = _splittable(xc @ params["wq"].to(xc.dtype), -1, H).reshape(
        B, S, H, N)
    k = _splittable(xc @ params["wk"].to(xc.dtype), -1, H).reshape(
        B, S, H, N) * _scalar(N ** -0.5, xc)
    v = _splittable(xm @ params["wv"].to(xm.dtype), -1, H).reshape(
        B, S, H, P)
    gates = xc @ params["w_gates"].to(xc.dtype) \
        + params["b_gates"].to(xc.dtype)
    i_pre, f_pre = torch.chunk(gates.float(), 2, dim=-1)
    g = -_softplus(-f_pre)                 # log sigmoid ≤ 0 (stable decay)
    i_gate = torch.sigmoid(i_pre)          # bounded input gate
    k = k * i_gate[..., None].to(k.dtype)
    # the normalizer n_t = Σ decay · i_j k_j rides as the (P+1)-th value
    # channel: v_aug = [v, 1]
    v_aug = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], -1)
    return q, k, v_aug, g, zg, new_conv


def mlstm_apply(params, cfg: ArchConfig, x, cache=None, decode=False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    B = x.shape[0]
    H, N, P = cfg.num_heads, cfg.lstm_head_qk, cfg.lstm_head_v
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    conv_state = cache["conv"] if decode else None
    q, k, v_aug, g, zg, new_conv = _mlstm_qkvg(params, cfg, h, conv_state)
    if decode:
        y_aug, S_new = gla_step(q[:, 0], k[:, 0], v_aug[:, 0], g[:, 0],
                                cache["S"])
        y_aug = y_aug[:, None]
    else:
        state0 = x.new_zeros((B, H, N, P + 1), dtype=torch.float32) \
            if cache is None else cache["S"]
        y_aug, S_new = gla_chunked(q, k, v_aug, g, state0, cfg.ssm_chunk)
    y, nq = y_aug[..., :P], y_aug[..., P:]
    y = y / _max1(_abs(nq)).to(y.dtype)
    y = y.reshape(B, -1, cfg.lstm_inner)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * _silu(zg)
    out = y @ params["down_proj"].to(y.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cfg.dtype), "S": S_new}
    return out, new_cache


# ----------------------------------------------------------------------
# sLSTM block (scalar cell, sequential scan — not parallelizable, per the
# xLSTM paper)
# ----------------------------------------------------------------------
def spec_slstm(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    return {
        "norm": spec_rmsnorm(d),
        "w_in": TensorSpec((d, 4 * d), ("embed", "lstm_in"), init="normal",
                           scale=d ** -0.5),
        "r": TensorSpec((4, H, dh, dh), (None, "lstm_heads", None, None),
                        init="normal", scale=dh ** -0.5),
        "b": TensorSpec((4 * d,), (None,), init="zeros"),
        "out_norm": spec_rmsnorm(d),
        "out_proj": TensorSpec((d, d), ("embed", "embed2"), init="normal",
                               scale=d ** -0.5),
    }


def slstm_cache_spec(cfg: ArchConfig, batch: int) -> Dict:
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads

    def mk():
        return TensorSpec((batch, H, dh), ("batch", "lstm_heads", None),
                          init="zeros", dtype=torch.float32)
    return {"c": mk(), "n": mk(), "h": mk()}


def _slstm_cell(r, b, wx_t, state):
    """One recurrence step. r: (H, dh, 4·dh), the recurrence weights
    (4, H, dh, dh) as one (dh, 4·dh) matrix per head; b: (4, H, dh);
    wx_t: (B, 4, H, dh) input projection at t; all fp32; state (c, n,
    h), each (B, H, dh) fp32."""
    c, n, hprev = state
    B, H, dh = hprev.shape
    # Σ_d h[b,h,d]·r[g,h,d,e], one batched product over the heads
    rec = torch.bmm(hprev.transpose(0, 1), r).view(H, B, 4, dh) \
        .permute(1, 2, 0, 3)
    pre = wx_t + rec + b
    sig = torch.sigmoid(pre)                 # bounded gates (module doc)
    i, f, o = sig[:, 0], sig[:, 1], sig[:, 3]
    z = torch.tanh(pre[:, 2])
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / _max1(n_new)
    return c_new, n_new, h_new


def slstm_apply(params, cfg: ArchConfig, x, cache=None, decode=False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d); one token loop serves prefill (S tokens from the
    cache's state, or zeros) and decode (S == 1)."""
    B, S, d = x.shape
    H = cfg.num_heads
    dh = d // H
    hin = rmsnorm(params["norm"], x, cfg.norm_eps)
    wx = hin @ params["w_in"].to(hin.dtype)              # (B, S, 4d)
    wx = _splittable(wx.float(), -1, 4).reshape(B, S, 4, H, dh)
    r = params["r"].float().permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)
    b = params["b"].float().reshape(4, H, dh)
    if cache is None:
        zeros = x.new_zeros((B, H, dh), dtype=torch.float32)
        state = (zeros, zeros, zeros)
    else:
        state = (cache["c"], cache["n"], cache["h"])
    ys = []
    for t in range(S):                       # decode: S == 1
        state = _slstm_cell(r, b, wx[:, t], state)
        ys.append(state[2])
    y = torch.stack(ys, 1).reshape(B, S, d).to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps)
    out = y @ params["out_proj"].to(y.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {"c": state[0], "n": state[1], "h": state[2]}
    return out, new_cache
