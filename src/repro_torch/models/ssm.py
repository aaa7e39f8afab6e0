"""State-space and recurrent sequence mixers: the chunkwise SSD core,
Mamba2 and the xLSTM blocks — the port of ``repro/models/ssm.py``.

One chunkwise-parallel SSD core (:func:`ssd_scan`, :func:`ssd_step`)
serves two architectures:

* **Mamba2** (zamba2-7b's mixer, ``models/hybrid.py``): selective state
  space with a per-head scalar decay ``exp(Δt·A)``, input ``Δt·x ⊗ B``,
  readout ``C·S``, a width-4 causal conv in front and a gated RMSNorm
  behind. ``a_log``, ``dt_bias`` and ``d_skip`` are float32 in any model
  dtype, as the reference's.
* **mLSTM** (xlstm-350m): matrix-memory LSTM. Algebraically an SSD with
  data-dependent decay ``σ(f̃)`` and input gate ``σ(ĩ)``; the normalizer
  state n is carried as an extra (P+1)-th channel of the same recurrence
  (sigmoid gates, the reference's stated deviation from the paper's
  exponential input gating).
* **sLSTM** (xlstm's scalar-memory block) has true recurrent weights, so
  it runs as a loop over time steps with the exponential-gating
  stabilizer state m. Where a gradient is wanted the loop is one autograd
  node (:class:`_SLSTMScan`) whose backward runs the recurrence's gradient
  back over time, written out in PyTorch: with a graph of every step's
  operations a train step of xlstm-350m on an H100 took about four times
  as long, with 1.6 times the launches (stated deviation: the reference
  differentiates its ``lax.scan``).

The SSD scan runs chunk by chunk, a Python loop in the reference's
``lax.scan`` order: intra-chunk terms are a masked quadratic contraction
over ``[Q, Q]`` score blocks, inter-chunk state flows through the carry.
Everything here is plain PyTorch: the reference computes it outside any
Pallas kernel.

Stated deviation (ROADMAP §C5): the reference takes ``exp`` of the whole
``[Q, Q]`` decay block and masks the upper triangle afterwards. Above the
diagonal the decay is a sum of up to Q - 1 positive terms (-log σ(f̃),
about 0.69 for gate logits near 0), so at Q = 256 ``exp`` overflows to
inf; the ``where`` drops it in the forward pass, but its gradient is
0 · inf = NaN. The port masks the exponent first, ``exp(where(mask, decay,
-inf))``, and keeps the reference's ``where`` on the product: the same
lower triangle, so the same forward values, and finite gradients equal to
the reference's wherever those are finite.

The other contractions are reassociated so that no ``[B, Q, H, P, N]``
intermediate is formed (``einsum("bqh,bhdn,bqn->bqhd")`` as the decay
times ``einsum("bqn,bhdn->bqhd")``): the same sums in float32.

Mamba2's decay is per head, ``dt·A`` with ``dt = softplus(·)``: at the
reference's initial ``a_log = 0`` and ``dt_bias = log(e - 1)`` it is
about -1 a step, so zamba2-7b's chunk of 256 overflows the unmasked
``exp`` as the mLSTM's does (ROADMAP §C5).

Parameters are mappings of name -> tensor (an ``nn.ParameterDict`` of
``models/xlstm.py``'s blocks and ``models/hybrid.py``'s Mamba layers),
weights in the ``x @ W`` orientation. Not ported: the ``*_specs``
functions (mesh layout).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rmsnorm

F32 = torch.float32

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# SSD core (chunkwise-parallel scalar-decay state space)
# ---------------------------------------------------------------------------

def ssd_scan(
    x: torch.Tensor,        # [B, L, H, P]  (inputs, already gate-scaled)
    log_a: torch.Tensor,    # [B, L, H]     per-step log decay (<= 0)
    b_in: torch.Tensor,     # [B, L, N]     input direction (single group)
    c_out: torch.Tensor,    # [B, L, N]     readout direction
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel scan of S_t = e^{log_a_t} S_{t-1} + x_t ⊗ b_t,
    y_t = S_t c_t. Returns (y [B, L, H, P] in x's dtype, the final state
    [B, H, P, N] float32). Raises ``ValueError`` unless ``min(chunk, L)``
    divides L, as the reference does."""
    bsz, l, h, p = x.shape
    n = b_in.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"L={l} not divisible by chunk={chunk}")
    nc = l // chunk

    xc = x.reshape(bsz, nc, chunk, h, p).to(F32)
    ac = log_a.reshape(bsz, nc, chunk, h).to(F32)
    bc = b_in.reshape(bsz, nc, chunk, n).to(F32)
    cc = c_out.reshape(bsz, nc, chunk, n).to(F32)

    s = (torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
         if init_state is None else init_state.to(F32))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for xq, aq, bq, cq in zip(xc.unbind(1), ac.unbind(1), bc.unbind(1),
                              cc.unbind(1)):
        cum = torch.cumsum(aq, dim=1)                      # [B, Q, H]
        # intra-chunk: y[q] += Σ_{p<=q} e^{cum_q - cum_p} (c_q·b_p) x_p
        scores = torch.einsum("bqn,bpn->bqp", cq, bq)[:, None]  # [B,1,Q,Q]
        decay = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        decay = torch.exp(torch.where(mask, decay, -math.inf))  # [B,H,Q,Qp]
        w = torch.where(mask, decay * scores, 0.0)
        y = torch.einsum("bhqp,bphd->bqhd", w, xq)
        # inter-chunk: y[q] += e^{cum_q} c_q · S_prev
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhdn->bqhd", cq, s)
        # state: S = e^{cum_Q} S_prev + Σ_q e^{cum_Q - cum_q} x_q ⊗ b_q
        total = cum[:, -1]                                  # [B, H]
        in_decay = torch.exp(total[:, None] - cum)          # [B, Q, H]
        s = torch.exp(total)[:, :, None, None] * s + torch.einsum(
            "bqhd,bqn->bhdn", in_decay[..., None] * xq, bq)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, l, h, p)
    return y.to(x.dtype), s


def ssd_step(
    x: torch.Tensor,        # [B, H, P]
    log_a: torch.Tensor,    # [B, H]
    b_in: torch.Tensor,     # [B, N]
    c_out: torch.Tensor,    # [B, N]
    state: torch.Tensor,    # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the same recurrence. Returns (y [B, H, P] in
    x's dtype, the new state float32)."""
    xf, af = x.to(F32), log_a.to(F32)
    s_new = torch.exp(af)[..., None, None] * state.to(F32) + torch.einsum(
        "bhd,bn->bhdn", xf, b_in.to(F32))
    y = torch.einsum("bhdn,bn->bhd", s_new, c_out.to(F32))
    return y.to(x.dtype), s_new


# ---------------------------------------------------------------------------
# Causal depthwise conv (the width-4 front conv)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, *,
                state: Optional[torch.Tensor] = None):
    """x [B, L, C], w [K, C] depthwise. Returns (silu(y) [B, L, C], the
    tail [B, K-1, C] that the next call takes as ``state``). The K taps
    are added left to right from 0 in x's dtype, as the reference's
    Python ``sum``."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                     # [B, L+K-1, C]
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + x.shape[1]] * w[i][None, None]
    return F.silu(y), xp[:, -(k - 1):]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, k: int, c: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``[k, c]`` normal x 0.1, drawn in float32 and cast."""
    w = torch.empty((k, c), dtype=F32, device=gen.device)
    return (w.normal_(generator=gen) * 0.1).to(dtype)


def mamba2_shapes(cfg) -> dict:
    """Name -> (shape, dtype) of a Mamba2 mixer's parameters (``a_log``,
    ``dt_bias`` and ``d_skip`` float32 in any model dtype)."""
    s, d, dt = cfg.ssm, cfg.d_model, cfg.torch_dtype
    d_inner = s.expand * d
    n_heads = d_inner // s.headdim
    n = s.d_state
    return {"in_proj": ((d, 2 * d_inner + 2 * n + n_heads), dt),
            "conv_w": ((s.d_conv, d_inner + 2 * n), dt),
            "a_log": ((n_heads,), F32),         # A = -exp(a_log)
            "dt_bias": ((n_heads,), F32),
            "d_skip": ((n_heads,), F32),
            "norm": ((d_inner,), dt),
            "out_proj": ((d_inner, d), dt)}


def mamba2_init(gen: torch.Generator, cfg) -> dict:
    """The reference's draws: ``in_proj`` and ``out_proj``
    ``dense_init``, ``conv_w`` normal x 0.1, ``a_log`` 0, ``dt_bias``
    log(e - 1) (softplus of it is 1), ``d_skip`` 1, the norm zero."""
    out = {}
    for name, (shape, dt) in mamba2_shapes(cfg).items():
        if name == "conv_w":
            out[name] = _conv_init(gen, *shape, dt)
        elif name in ("in_proj", "out_proj"):
            out[name] = dense_init(gen, *shape, dt)
        else:
            fill = {"a_log": 0.0, "dt_bias": math.log(math.e - 1),
                    "d_skip": 1.0, "norm": 0.0}[name]
            out[name] = torch.full(shape, fill, dtype=dt,
                                   device=gen.device)
    return out


def _mamba2_split(cfg, proj):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n = s.d_state
    n_heads = d_inner // s.headdim
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n]
    dt_raw = proj[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt_raw, d_inner, n, n_heads


def mamba2_apply(params: Params, cfg, x: torch.Tensor, *, cache=None):
    """Mamba2 mixer, x [B, L, d]. ``cache=None`` runs the scan;
    ``cache=(conv_tail, state)`` with L == 1 runs one decode step (L > 1
    scans on from the cache). Returns (out [B, L, d], (conv_tail [B, K-1,
    d_inner + 2N] in the model dtype, state [B, H, P, N] float32)).
    Rounded in the model dtype at the reference's points: ``x · dt``,
    ``d_skip · x`` and ``rmsnorm(y) · silu(z)``."""
    s = cfg.ssm
    bsz, l, _ = x.shape
    proj = x @ params["in_proj"]
    z, xbc, dt_raw, d_inner, n, n_heads = _mamba2_split(cfg, proj)

    conv_state = None if cache is None else cache[0]
    xbc, conv_tail = causal_conv(xbc, params["conv_w"], state=conv_state)
    x_in = xbc[..., :d_inner].reshape(bsz, l, n_heads, s.headdim)
    b_in = xbc[..., d_inner:d_inner + n]
    c_out = xbc[..., d_inner + n:]

    dt_v = F.softplus(dt_raw.to(F32) + params["dt_bias"])      # [B, L, H]
    log_a = dt_v * -torch.exp(params["a_log"])
    x_scaled = x_in * dt_v[..., None].to(x_in.dtype)

    ssd_state = None if cache is None else cache[1]
    if cache is not None and l == 1:
        y, state = ssd_step(x_scaled[:, 0], log_a[:, 0], b_in[:, 0],
                            c_out[:, 0], ssd_state)
        y = y[:, None]
    else:
        y, state = ssd_scan(x_scaled, log_a, b_in, c_out, chunk=s.chunk,
                            init_state=ssd_state)
    y = y + params["d_skip"][None, None, :, None].to(y.dtype) * x_in
    y = y.reshape(bsz, l, d_inner)
    y = rmsnorm(y, params["norm"], cfg.norm_eps) * F.silu(z)
    return y @ params["out_proj"], (conv_tail, state)


def mamba2_cache_init(cfg, batch: int, device=None) -> tuple:
    """(conv tail [B, K-1, d_inner + 2N] in the model dtype, SSD state [B,
    H, P, N] float32), zero."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    conv = torch.zeros((batch, s.d_conv - 1, d_inner + 2 * s.d_state),
                       dtype=cfg.torch_dtype, device=device)
    state = torch.zeros((batch, n_heads, s.headdim, s.d_state), dtype=F32,
                        device=device)
    return conv, state


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block (matrix memory — SSD with sigmoid gates + normalizer)
# ---------------------------------------------------------------------------

def mlstm_shapes(cfg) -> dict:
    """Name -> (shape, dtype) of an mLSTM mixer's parameters."""
    d, dt = cfg.d_model, cfg.torch_dtype
    d_inner = cfg.ssm.expand * d
    return {"in_proj": ((d, 2 * d_inner), dt),          # x branch, z gate
            "conv_w": ((cfg.ssm.d_conv, d_inner), dt),
            "wqkv": ((d_inner, 3 * d_inner), dt),
            "wif": ((d_inner, 2 * cfg.n_heads), dt),     # i, f gate logits
            "norm": ((d_inner,), dt),
            "out_proj": ((d_inner, d), dt)}


def mlstm_init(gen: torch.Generator, cfg) -> dict:
    """The reference's draws: the matrices ``dense_init``, ``conv_w``
    normal x 0.1, the norm zero."""
    shapes = mlstm_shapes(cfg)
    out = {}
    for name, (shape, dt) in shapes.items():
        if name == "conv_w":
            out[name] = _conv_init(gen, *shape, dt)
        elif name == "norm":
            out[name] = torch.zeros(shape, dtype=dt, device=gen.device)
        else:
            out[name] = dense_init(gen, *shape, dt)
    return out


def mlstm_apply(params: Params, cfg, x: torch.Tensor, *, cache=None):
    """mLSTM mixer, x [B, L, d]. Matrix memory C over (head, P = headdim,
    N = headdim); the normalizer n rides as channel P (the x side
    augmented with the input gate). ``cache=None`` runs the scan;
    ``cache=(conv_tail, state)`` with L == 1 runs one decode step (L > 1
    scans on from the cache). Returns (out [B, L, d], (conv_tail,
    state))."""
    s = cfg.ssm
    bsz, l, _ = x.shape
    h = cfg.n_heads
    proj = x @ params["in_proj"]
    d_inner = proj.shape[-1] // 2
    xb, z = proj[..., :d_inner], proj[..., d_inner:]
    ph = d_inner // h

    conv_state = None if cache is None else cache[0]
    xb, conv_tail = causal_conv(xb, params["conv_w"], state=conv_state)

    qkv = xb @ params["wqkv"]
    q = qkv[..., :d_inner].reshape(bsz, l, h, ph)
    k = qkv[..., d_inner:2 * d_inner].reshape(bsz, l, h, ph)
    v = qkv[..., 2 * d_inner:].reshape(bsz, l, h, ph)
    gates = (xb @ params["wif"]).to(F32).reshape(bsz, l, h, 2)
    i_g = torch.sigmoid(gates[..., 0])
    log_f = F.logsigmoid(gates[..., 1])

    # heads fold into the SSD batch dim (per-head b/c directions); v * i
    # and q * scale are rounded in the model dtype, as the reference's
    scale = 1.0 / math.sqrt(ph)
    i_v = i_g[..., None].to(v.dtype)
    v_aug = torch.cat([v * i_v, i_v], dim=-1)              # [B,L,H,P+1]
    vb = v_aug.transpose(1, 2).reshape(bsz * h, l, 1, ph + 1)
    kb = k.transpose(1, 2).reshape(bsz * h, l, ph).to(F32)
    qb = (q.transpose(1, 2).reshape(bsz * h, l, ph) * scale).to(F32)
    ab = log_f.transpose(1, 2).reshape(bsz * h, l, 1)

    state0 = None if cache is None else cache[1]
    if cache is not None and l == 1:
        y, state = ssd_step(vb[:, 0], ab[:, 0], kb[:, 0], qb[:, 0], state0)
        y = y[:, None]
    else:
        y, state = ssd_scan(vb, ab, kb, qb, chunk=s.chunk, init_state=state0)
    y = y.reshape(bsz, h, l, ph + 1).transpose(1, 2)      # [B,L,H,P+1]
    num, den = y[..., :ph], y[..., ph]
    y = num / torch.clamp(torch.abs(den), min=1.0)[..., None].to(num.dtype)
    y = y.reshape(bsz, l, d_inner)
    y = rmsnorm(y, params["norm"], cfg.norm_eps) * F.silu(z)
    return y @ params["out_proj"], (conv_tail, state)


def mlstm_cache_init(cfg, batch: int, device=None) -> tuple:
    """(conv tail [B, K-1, d_inner] in the model dtype, matrix state [B·H,
    1, P+1, P] float32), zero."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = cfg.n_heads
    ph = d_inner // h
    conv = torch.zeros((batch, s.d_conv - 1, d_inner),
                       dtype=cfg.torch_dtype, device=device)
    state = torch.zeros((batch * h, 1, ph + 1, ph), dtype=F32, device=device)
    return conv, state


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (scalar memory, true recurrence -> loop over time)
# ---------------------------------------------------------------------------

def slstm_shapes(cfg) -> dict:
    """Name -> (shape, dtype) of an sLSTM mixer's parameters (``r_rec``
    float32 in any model dtype)."""
    d, dt = cfg.d_model, cfg.torch_dtype
    return {"w_in": ((d, 4 * d), dt),                   # i, f, z, o pre-acts
            "r_rec": ((d, 4 * d), F32),
            "norm": ((d,), dt),
            "out_proj": ((d, d), dt)}


def slstm_init(gen: torch.Generator, cfg) -> dict:
    """The reference's draws: ``w_in`` and ``out_proj`` ``dense_init``,
    ``r_rec`` ``dense_init`` x 0.1 in float32, the norm zero."""
    d, dt = cfg.d_model, cfg.torch_dtype
    return {"w_in": dense_init(gen, d, 4 * d, dt),
            "r_rec": dense_init(gen, d, 4 * d, F32) * 0.1,
            "norm": torch.zeros((d,), dtype=dt, device=gen.device),
            "out_proj": dense_init(gen, d, d, dt)}


def _slstm_forward(pre_in: torch.Tensor, r: torch.Tensor, c, n, h, m):
    """The sLSTM recurrence over ``pre_in`` [L, B, 4d] (the input
    projections, time-major) from the state (c, n, h, m), each [B, d].
    Returns the buffers (PRE, C, N, M, H), each [L, ...]: every step's
    pre-activations (with the recurrent term ``h @ r``) and its state after
    the step. Each step writes its results into its row of the buffers
    (``out=``): 16 launches a step, no copies."""
    l, b, d4 = pre_in.shape
    d = d4 // 4
    new = lambda k: torch.empty((l, b, k), dtype=pre_in.dtype,
                                device=pre_in.device)
    pre_buf, c_buf, n_buf, m_buf, h_buf = new(d4), new(d), new(d), new(d), \
        new(d)
    for t in range(l):
        pre = torch.addmm(pre_in[t], h, r, out=pre_buf[t])   # recurrent term
        ig, fg, zg, og = pre.split(d, dim=-1)
        log_fm = F.logsigmoid(fg).add_(m)
        m = torch.maximum(log_fm, ig, out=m_buf[t])
        f_s = torch.exp(log_fm.sub_(m))
        i_s = torch.exp(ig - m)
        c = torch.addcmul(f_s * c, i_s, torch.tanh(zg), out=c_buf[t])
        n = torch.addcmul(i_s, f_s, n, out=n_buf[t])
        h = torch.div(torch.sigmoid(og).mul_(c), torch.clamp(n, min=1e-6),
                      out=h_buf[t])
    return pre_buf, c_buf, n_buf, m_buf, h_buf


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence as one autograd node: the forward runs
    :func:`_slstm_forward` with no graph of its own; the backward runs the
    recurrence's gradient back over time, its per-step factors computed
    for all steps at once from the saved buffers, and the gradient of
    ``r`` as one product over all steps. Inputs: ``pre_in`` [L, B, 4d],
    ``r`` [d, 4d] and the initial (c, n, h, m); outputs: H [L, B, d] and
    the final (c, n, h, m). ``torch.maximum`` sends half the gradient to
    each side of a tie, as ``jnp.maximum``; ``clamp`` passes it where n >=
    1e-6."""

    @staticmethod
    def forward(ctx, pre_in, r, c0, n0, h0, m0):
        pre, c, n, m, h = _slstm_forward(pre_in, r, c0, n0, h0, m0)
        ctx.save_for_backward(pre, c, n, m, h, r, c0, n0, h0, m0)
        return h, c[-1].clone(), n[-1].clone(), h[-1].clone(), m[-1].clone()

    @staticmethod
    def backward(ctx, d_hs, d_c, d_n, d_h, d_m):
        pre, c, n, m, h, r, c0, n0, h0, m0 = ctx.saved_tensors
        l, b, d = c.shape
        prev = lambda first, buf: torch.cat([first[None], buf[:-1]])
        c_prev, n_prev, m_prev, h_prev = (prev(c0, c), prev(n0, n),
                                          prev(m0, m), prev(h0, h))
        ig, fg, zg, og = pre.split(d, dim=-1)
        log_fm = F.logsigmoid(fg) + m_prev
        f_s = torch.exp(log_fm - m)
        i_s = torch.exp(ig - m)
        z_t = torch.tanh(zg)
        s_o = torch.sigmoid(og)
        inv = 1.0 / torch.clamp(n, min=1e-6)
        k_c = s_o * inv                                    # dc += dh k_c
        k_n = -h * inv * (n >= 1e-6)                       # dn += dh k_n
        k_o = h * (1 - s_o)                                # d og = dh k_o
        k_z = i_s * (1 - z_t * z_t)                        # d zg = dc k_z
        w_a = torch.where(log_fm == ig, 0.5, (log_fm > ig).to(pre.dtype))
        w_i = 1 - w_a
        s_nf = torch.sigmoid(-fg)                          # d logsigmoid
        zeros = lambda: torch.zeros((b, d), dtype=pre.dtype,
                                    device=pre.device)
        g = lambda x: zeros() if x is None else x
        dc, dn, dh, dm = g(d_c), g(d_n), g(d_h), g(d_m)
        d_pre = torch.empty_like(pre)
        rt = r.t()
        for t in range(l - 1, -1, -1):
            if d_hs is not None:
                dh = dh + d_hs[t]
            dc = torch.addcmul(dc, dh, k_c[t])
            dn = torch.addcmul(dn, dh, k_n[t])
            row = d_pre[t]
            torch.mul(dh, k_o[t], out=row[:, 3 * d:])
            d_fs = torch.addcmul(dc * c_prev[t], dn, n_prev[t])
            d_is = torch.addcmul(dn, dc, z_t[t])
            torch.mul(dc, k_z[t], out=row[:, 2 * d:3 * d])
            u = d_fs.mul_(f_s[t])
            v = d_is.mul_(i_s[t])
            dm_t = dm - u - v
            da = torch.addcmul(u, dm_t, w_a[t])
            torch.addcmul(v, dm_t, w_i[t], out=row[:, :d])
            torch.mul(da, s_nf[t], out=row[:, d:2 * d])
            dc, dn, dm = dc * f_s[t], dn * f_s[t], da
            dh = row @ rt
        d_r = h_prev.reshape(l * b, d).t() @ d_pre.reshape(l * b, 4 * d)
        return d_pre, d_r, dc, dn, dh, dm


def slstm_apply(params: Params, cfg, x: torch.Tensor, *, cache=None):
    """x [B, L, d] -> ([B, L, d], (c, n, h, m)). Exponential gating with
    the stabilizer m; the input projection is a product in the model dtype
    cast to float32 afterwards, the recurrence ``h @ r`` float32. The loop
    over time runs in :class:`_SLSTMScan` (one autograd node for the whole
    scan) where a gradient is wanted, else :func:`_slstm_forward`."""
    bsz, l, d = x.shape
    pre_all = (x @ params["w_in"]).to(F32)                # [B, L, 4d]
    r = params["r_rec"].to(F32)
    state = (slstm_cache_init(cfg, bsz, device=x.device) if cache is None
             else cache)
    pre_in = pre_all.transpose(0, 1).contiguous()         # [L, B, 4d]
    if torch.is_grad_enabled() and (pre_in.requires_grad or r.requires_grad
                                    or any(t.requires_grad for t in state)):
        hs, c, n, h, m = _SLSTMScan.apply(pre_in, r, *state)
    else:
        _, cs, ns, ms, hs = _slstm_forward(pre_in, r, *state)
        # the final state alone, not views that keep every step's rows
        c, n, h, m = (t[-1].clone() for t in (cs, ns, hs, ms))
    y = hs.transpose(0, 1).to(x.dtype)                    # [B, L, d]
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], (c, n, h, m)


def slstm_cache_init(cfg, batch: int, device=None) -> tuple:
    """(c, n, h, m), each [B, d] float32: zero, but n = 1e-6."""
    z = lambda: torch.zeros((batch, cfg.d_model), dtype=F32, device=device)
    return z(), torch.full((batch, cfg.d_model), 1e-6, dtype=F32,
                           device=device), z(), z()
