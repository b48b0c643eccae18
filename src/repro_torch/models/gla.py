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

In a sharded step (DTensors) the chunked GLA and the sLSTM's token loop
run on every rank's batch rows and heads under `local_map`
(`_per_head`): both are independent per (batch row, head), so no
collective runs inside. There the sLSTM loop is one op pair,
`repro_torch::slstm_scan` and its backward (back-propagation through
time written out, `_slstm_scan_grads`), so a trace on fake tensors (the
dry-run) dispatches one op per layer instead of a dozen per token.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (_gathered, _pinned, _silu,
                                       _splittable, rmsnorm, spec_rmsnorm)
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
# sharded runs: a recurrence per (batch row, head) on local shards
# ----------------------------------------------------------------------
def _per_head(fn, args, dims, out_dims):
    """fn on every rank's local shards of the DTensors `args` under
    `local_map`, for a computation that is independent per (batch row,
    head): dims[i] = (batch dim or None, head dim) of args[i], out_dims
    the same for fn's outputs. The batch is laid over the data axes and
    the heads over 'model', each where it divides (replicated
    otherwise, as on a mesh dim of one rank), so no collective runs
    inside fn. An argument without a batch dim (a param) is replicated
    over the data axes and its gradient is partial there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    names = tuple(mesh.mesh_dim_names)
    ref, (bd, hd) = next((t, d) for t, d in zip(args, dims)
                         if d[0] is not None)
    data = math.prod(mesh.size(i) for i, a in enumerate(names)
                     if a in ("pod", "data"))
    by_batch = ref.shape[bd] % data == 0
    by_heads = "model" in names and \
        ref.shape[hd] % mesh.size(names.index("model")) == 0

    def layout(d, unbatched):
        batch_dim, head_dim = d
        on_data = Shard(batch_dim) if batch_dim is not None else unbatched
        return tuple(
            Replicate() if mesh.size(i) == 1 else
            (on_data if by_batch else Replicate()) if a in ("pod", "data")
            else Shard(head_dim) if a == "model" and by_heads
            else Replicate() for i, a in enumerate(names))
    in_pl = tuple(layout(d, Replicate()) for d in dims)
    args = tuple(t.redistribute(mesh, p) for t, p in zip(args, in_pl))
    return local_map(
        fn, out_placements=tuple(layout(d, None) for d in out_dims),
        in_placements=in_pl,
        in_grad_placements=tuple(layout(d, Partial()) for d in dims),
        device_mesh=mesh)(*args)


# ----------------------------------------------------------------------
# chunked GLA core
# ----------------------------------------------------------------------
def gla_chunked(q, k, v, g, state, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, S, H, N); v: (B, S, H, P); g: (B, S, H) log-decay ≤ 0;
    state: (B, H, N, P) incoming. Returns (y (B, S, H, P) in v's dtype,
    state_out fp32). On DTensors it runs on every rank's batch rows and
    heads (`_per_head`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _per_head(lambda *a: gla_chunked(*a, chunk),
                         (q, k, v, g, state),
                         ((0, 2),) * 4 + ((0, 1),), ((0, 2), (0, 1)))
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
    y = _pinned(y.reshape(x.shape[0], -1, di))
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
    y = _pinned(y.reshape(B, -1, cfg.lstm_inner))
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
    sig, z = _slstm_gates(r, b, wx_t, hprev)
    i, f, o = sig[:, 0], sig[:, 1], sig[:, 3]
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / _max1(n_new)
    return c_new, n_new, h_new


def _slstm_gates(r, b, wx_t, hprev):
    """(σ of the four gates' pre-activations (B, 4, H, dh), tanh of the
    cell input's) at one step (`_slstm_cell`'s shapes)."""
    B, H, dh = hprev.shape
    # Σ_d h[b,h,d]·r[g,h,d,e], one batched product over the heads
    rec = torch.bmm(hprev.transpose(0, 1), r).view(H, B, 4, dh) \
        .permute(1, 2, 0, 3)
    pre = wx_t + rec + b
    sig = torch.sigmoid(pre)                 # bounded gates (module doc)
    return sig, torch.tanh(pre[:, 2])


def _slstm_scan(r, b, wx, state):
    """The token loop over wx (B, S, 4, H, dh) from `state` (c, n, h),
    or zeros: (h of every step (B, S, H, dh), the last state)."""
    if state is None:
        zeros = wx.new_zeros((wx.shape[0],) + tuple(wx.shape[3:]))
        state = (zeros, zeros, zeros)
    ys = []
    for t in range(wx.shape[1]):             # decode: S == 1
        state = _slstm_cell(r, b, wx[:, t], state)
        ys.append(state[2])
    return torch.stack(ys, 1), state


def _slstm_scan_grads(r, b, wx, c0, n0, h0, gy, gc, gn, gh):
    """Back-propagation through `_slstm_scan` from (c0, n0, h0): the
    gradients of (r, b, wx, c0, n0, h0) given those of its outputs (gy
    of every step's h, and gc, gn, gh of the last state). The forward is
    recomputed first, keeping each step's gates and state. The
    reference's derivatives: max(n, 1) splits a tie."""
    B, S, _, H, dh = wx.shape
    states, gates = [(c0, n0, h0)], []
    for t in range(S):
        c, n, h = states[-1]
        sig, z = _slstm_gates(r, b, wx[:, t], h)
        c = sig[:, 1] * c + sig[:, 0] * z
        n = sig[:, 1] * n + sig[:, 0]
        states.append((c, n, sig[:, 3] * c / _max1(n)))
        gates.append((sig, z))
    dr, dpre = torch.zeros_like(r), [None] * S
    for t in reversed(range(S)):
        (c_p, n_p, h_p), (c, n, h) = states[t], states[t + 1]
        (sig, z), m = gates[t], _max1(n)
        i, f, o = sig[:, 0], sig[:, 1], sig[:, 3]
        g_h = gy[:, t] + gh
        dq = g_h / m                        # h = q / m, q = o·c
        gc = dq * o + gc
        tie = (n > 1).to(n.dtype) + 0.5 * (n == 1).to(n.dtype)
        gn = -(g_h * h) / m * tie + gn
        dpre[t] = torch.stack([(gc * z + gn) * (i * (1 - i)),
                               (gc * c_p + gn * n_p) * (f * (1 - f)),
                               gc * i * (1 - z * z),
                               dq * c * (o * (1 - o))], 1)
        drec = dpre[t].permute(2, 0, 1, 3).reshape(H, B, 4 * dh)
        gh = torch.bmm(drec, r.transpose(1, 2)).transpose(0, 1)
        dr = dr + torch.bmm(h_p.transpose(0, 1).transpose(1, 2), drec)
        gc, gn = gc * f, gn * f
    dwx = torch.stack(dpre, 1)
    return dr, dwx.sum((0, 1)), dwx, gc, gn, gh


# The token loop as one op pair (forward, backward) for the sharded
# runs: each rank runs it on its local shards, and a trace on fake
# tensors (the dry-run) dispatches one op per layer, not S steps of a
# dozen. Its FLOPs are the loop's products: one (B, dh)·(dh, 4·dh) per
# head and step forward, three in the backward (the recomputed forward,
# the state's and r's gradients).
@torch.library.custom_op(
    "repro_torch::slstm_scan", mutates_args=(),
    schema="(Tensor r, Tensor b, Tensor wx, Tensor c, Tensor n, "
           "Tensor h) -> (Tensor, Tensor, Tensor, Tensor)")
def _slstm_scan_op(r, b, wx, c, n, h):
    y, (c, n, h) = _slstm_scan(r, b, wx, (c, n, h))
    return y, c, n, h


@torch.library.custom_op(
    "repro_torch::slstm_scan_backward", mutates_args=(),
    schema="(Tensor r, Tensor b, Tensor wx, Tensor c, Tensor n, Tensor h, "
           "Tensor gy, Tensor gc, Tensor gn, Tensor gh) -> (Tensor, Tensor, "
           "Tensor, Tensor, Tensor, Tensor)")
def _slstm_scan_backward_op(r, b, wx, c, n, h, gy, gc, gn, gh):
    return _slstm_scan_grads(r, b, wx, c, n, h, gy, gc, gn, gh)


@_slstm_scan_op.register_fake
def _(r, b, wx, c, n, h):
    B, S, _, H, dh = wx.shape
    return (wx.new_empty((B, S, H, dh)), torch.empty_like(c),
            torch.empty_like(n), torch.empty_like(h))


@_slstm_scan_backward_op.register_fake
def _(r, b, wx, c, n, h, gy, gc, gn, gh):
    return tuple(torch.empty_like(t) for t in (r, b, wx, c, n, h))


def _slstm_scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _slstm_scan_backward(ctx, gy, gc, gn, gh):
    return _slstm_scan_backward_op(*ctx.saved_tensors, gy, gc, gn, gh)


_slstm_scan_op.register_autograd(_slstm_scan_backward,
                                 setup_context=_slstm_scan_setup)


def _scan_flops(wx_shape, passes: int) -> int:
    B, S, _, H, dh = wx_shape
    return passes * 2 * B * S * H * dh * 4 * dh


register_flop_formula(torch.ops.repro_torch.slstm_scan)(
    lambda r, b, wx, *_, **__: _scan_flops(wx, 1))
register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)(
    lambda r, b, wx, *_, **__: _scan_flops(wx, 3))


def _slstm_sharded(r, b, wx, state):
    """`_slstm_scan` on DTensors (`_per_head`): r and b sliced per rank,
    wx laid out by heads (its 4·d dim is gates-major, so a contiguous
    shard of it holds gates, not heads). h comes back gathered over
    'model'."""
    def scan(r_, b_, w_, *st):
        if not st:
            st = (w_.new_zeros((w_.shape[0],) + tuple(w_.shape[3:])),) * 3
        return _slstm_scan_op(r_, b_, w_, *st)
    args = (r, b, wx) + (state or ())
    y, *state = _per_head(scan, args,
                          ((None, 0), (None, 1), (0, 3), (0, 1), (0, 1),
                           (0, 1))[:len(args)], ((0, 2),) + ((0, 1),) * 3)
    return _gathered(y, 2), tuple(state)


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
    state = None if cache is None else (cache["c"], cache["n"], cache["h"])
    from torch.distributed.tensor import DTensor
    if isinstance(wx, DTensor):
        y, state = _slstm_sharded(r, b, wx, state)
    else:
        y, state = _slstm_scan(r, b, wx, state)
    y = _pinned(y.reshape(B, S, d)).to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps)
    out = y @ params["out_proj"].to(y.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {"c": state[0], "n": state[1], "h": state[2]}
    return out, new_cache
