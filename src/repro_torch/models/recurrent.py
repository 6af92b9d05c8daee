"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin) and xLSTM (sLSTM,
mLSTM). A port of ``repro/models/recurrent.py``; pure functions of
``(cfg, p, x, *, state=None)`` returning ``(x, new_state)`` with the
reference's state keys (``new_state`` is None when no state is given).

Numerics kept from the reference, each with a CPU test:
- ``_causal_conv1d`` sums its K taps one product at a time in the input's
  dtype, as the reference's Python ``sum`` does: in bf16 every product and
  every partial sum rounds, which XLA does too and ``F.conv1d`` (one fp32
  sum, one rounding) does not.
- The RG-LRU is linear in h, so its scan order is free (the reference's
  ``lax.associative_scan``); here a log-depth doubling scan over the
  sequence with h0 as a pseudo-step: ~log2(S) steps of whole-tensor ops
  instead of S steps of launches.
- The mLSTM takes the chunkwise-parallel form when ``S % 64 == 0 and
  S > 64`` and the sequential scan otherwise (decode, short prompts), by
  the reference's rule.
- The mLSTM's two SiLUs are ``jax.nn.silu``'s expansion (``_silu``).
- The sLSTM's per-head recurrent product is regrouped to the global
  ``[z|i|f|o]`` layout before the gate split.

A given mLSTM state's matrix memory ``C`` (4 MB a head at xlstm-1.3b's
width) is updated in place and returned as the same tensor, as a decode
cache's K/V are (the reference donates its cache to the jitted step); the
other state leaves are returned new. While autograd records (training),
C is updated out of place instead: earlier products saved it for
backward. The arithmetic is the same either way (``_in_place``).

On a mesh the projections run on DTensors and the convolution and the
recurrences (the RG-LRU scan, the mLSTM, the sLSTM's step loop) run on
each rank's batch rows (``parallel.shard_map.batch_local``), on plain
tensors; the blocks' outputs are constrained to ``batch`` and ``act_tp``
as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel.shard_map import batch_local
from repro_torch.parallel.sharding import constrain, split_heads

# ---------------------------------------------------------------------------
# RG-LRU (Griffin recurrent block)
# ---------------------------------------------------------------------------

_LRU_C = 8.0


def rglru_specs(cfg: ModelConfig, n: int) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    dt = cfg.torch_dtype
    return {
        "ln": ParamSpec((n, d), ("layers", None), "ones", dt),
        "w_gate_in": ParamSpec((n, d, w), ("layers", "fsdp", "tp"), "normal", dt),
        "w_rec_in": ParamSpec((n, d, w), ("layers", "fsdp", "tp"), "normal", dt),
        "conv_w": ParamSpec((n, cfg.conv1d_width, w), ("layers", None, "tp"), "normal", dt),
        "conv_b": ParamSpec((n, w), ("layers", "tp"), "zeros", dt),
        "w_a": ParamSpec((n, w, w), ("layers", "fsdp", "tp"), "normal", dt),
        "w_i": ParamSpec((n, w, w), ("layers", "fsdp", "tp"), "normal", dt),
        "lam": ParamSpec((n, w), ("layers", "tp"), ("uniform", 1.0), torch.float32),
        "w_out": ParamSpec((n, w, d), ("layers", "tp_in", "fsdp"), "normal", dt),
        "mlp": {
            "w_gate": ParamSpec((n, d, cfg.d_ff), ("layers", "fsdp", "tp"), "normal", dt),
            "w_up": ParamSpec((n, d, cfg.d_ff), ("layers", "fsdp", "tp"), "normal", dt),
            "w_down": ParamSpec((n, cfg.d_ff, d), ("layers", "tp_in", "fsdp"), "normal", dt),
        },
        "ln2": ParamSpec((n, d), ("layers", None), "ones", dt),
    }


def _causal_conv1d(x, w, b, state=None):
    """Per-channel causal conv. x: (B,S,W); w: (K,W); state: (B,K-1,W).
    The taps are summed one product at a time in x's dtype (the
    reference's Python ``sum``), not by ``F.conv1d``."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, W)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return out + b, new_state


def _rglru_core(x, r, i, lam, h0):
    """x,r,i: (B,S,W) fp32 post-activation inputs; returns (y, h_last).

    h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t),
    log a_t = -c * softplus(lam) * r_t. Linear in h: a doubling scan of
    (a, b) pairs under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), with h0
    prepended as the pseudo-step (1, h0)."""
    log_a = (-_LRU_C * F.softplus(lam.float()))[None, None, :] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x)
    a_all = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    b_all = torch.cat([h0[:, None, :], gated], dim=1)
    n, off = a_all.shape[1], 1
    while off < n:
        b_all = torch.cat([b_all[:, :off],
                           a_all[:, off:] * b_all[:, :-off] + b_all[:, off:]],
                          dim=1)
        a_all = torch.cat([a_all[:, :off], a_all[:, off:] * a_all[:, :-off]],
                          dim=1)
        off *= 2
    return b_all[:, 1:], b_all[:, -1]


def apply_rglru_block(cfg, p, x, *, state=None):
    """Griffin recurrent block. state: {'h': (B,W) fp32, 'conv': (B,K-1,W)}."""
    b, s, d = x.shape
    w = cfg.lru_width
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu((xn @ p["w_gate_in"]).float(), approximate="tanh")
    rec = xn @ p["w_rec_in"]
    conv_state = state["conv"] if state is not None else None
    rec, new_conv = batch_local(
        _causal_conv1d, (rec, p["conv_w"], p["conv_b"], conv_state),
        (True, False, False, True))
    r = torch.sigmoid((rec @ p["w_a"]).float())
    i = torch.sigmoid((rec @ p["w_i"]).float())
    h0 = (state["h"] if state is not None else
          torch.zeros((b, w), dtype=torch.float32, device=x.device))
    y, h_last = batch_local(_rglru_core, (rec.float(), r, i, p["lam"], h0),
                            (True, True, True, False, True))
    y = constrain((y * gate).to(x.dtype), ("batch", None, "act_tp"))
    x = x + y @ p["w_out"]
    x = x + L.swiglu_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                         p["mlp"]["w_gate"], p["mlp"]["w_up"],
                         p["mlp"]["w_down"])
    new_state = None
    if state is not None:
        new_state = {"h": h_last, "conv": new_conv}
    return constrain(x, ("batch", None, None)), new_state


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    inner = 2 * d
    dh = inner // cfg.num_heads
    dt = cfg.torch_dtype
    # block-diagonal per-head q/k/v (xLSTM paper's layout; 4x fewer
    # params than dense inner x inner)
    heads = ParamSpec((n, cfg.num_heads, dh, dh), ("layers", "tp", None, None),
                      "normal", dt)
    return {
        "ln": ParamSpec((n, d), ("layers", None), "ones", dt),
        "w_up": ParamSpec((n, d, inner), ("layers", "fsdp", "tp"), "normal", dt),
        "w_gate": ParamSpec((n, d, inner), ("layers", "fsdp", "tp"), "normal", dt),
        "conv_w": ParamSpec((n, cfg.conv1d_width, inner), ("layers", None, "tp"), "normal", dt),
        "conv_b": ParamSpec((n, inner), ("layers", "tp"), "zeros", dt),
        "wq": heads,
        "wk": heads,
        "wv": heads,
        "w_if": ParamSpec((n, inner, 2 * cfg.num_heads), ("layers", "fsdp", None), "normal", dt),
        "w_down": ParamSpec((n, inner, d), ("layers", "tp_in", "fsdp"), "normal", dt),
    }


MLSTM_CHUNK = 64


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` as XLA computes it: ``x * (1 / (1 + exp(-x)))``,
    each step rounded in x's dtype. ``F.silu`` rounds once; in bf16 the
    two part by an ulp on a quarter of the inputs, and the mLSTM's
    exponential gates carry that far (at ``reduce()``'s init scale, S 64,
    to 0.79 of max |out| against 0.0012 for this form).

    The backward is ``jax.vjp``'s of ``x * logistic(x)``, step for step:
    ``g s + (x g) (s (1 - s))`` with ``s`` the forward's rounded logistic
    (bitwise JAX's in bf16). Differentiating the expansion instead would
    multiply ``exp(-x)`` = inf by 0 below x ~ -88 (fp32) and give NaN
    where JAX's gradient is finite."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


def _silu(x):
    return _Silu.apply(x)


def _const(c: float, like) -> float:
    """A Python constant as JAX uses it against an array of ``like``'s
    dtype: rounded to that dtype first (a weak-typed scalar). PyTorch
    multiplies a bf16 tensor by the unrounded constant in fp32."""
    return float(torch.tensor(c, dtype=like.dtype))


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu`` (the tanh form) as XLA computes it, op by op in x's
    dtype with its constants rounded to that dtype (``_const``) and
    ``x ** 3`` as two products; ``F.gelu`` rounds once, and in bf16 parts
    from the reference on 30% of the sLSTM MLP's outputs at ``reduce()``.
    The backward is ``jax.vjp``'s, step for step: the product's two
    cotangents, ``tanh``'s ``(c + c th)`` with ``c = ct (1 - th)``, the
    constants' products, ``integer_pow``'s ``ct * (3 x^2)``, and the three
    cotangents of x summed in JAX's order (bitwise JAX's in bf16)."""

    @staticmethod
    def forward(ctx, x):
        x3 = x * x * x
        th = torch.tanh(_const(math.sqrt(2 / math.pi), x)
                        * (x + _const(0.044715, x) * x3))
        cdf = 0.5 * (1.0 + th)
        ctx.save_for_backward(x, th, cdf)
        return x * cdf

    @staticmethod
    def backward(ctx, g):
        x, th, cdf = ctx.saved_tensors
        ct_y = g * cdf                           # y = x * cdf
        c = (0.5 * (x * g)) * (1.0 - th)         # through cdf, 1 + th
        ct_t = c + c * th                        # tanh
        ct_s = _const(math.sqrt(2 / math.pi), x) * ct_t
        ct_x3 = _const(0.044715, x) * ct_s
        return (ct_y + ct_s) + ct_x3 * (3.0 * (x * x))


def _gelu(x):
    """``_Gelu`` in bf16, where the roundings part; ``F.gelu`` in one
    launch otherwise."""
    if x.dtype == torch.bfloat16:
        return _Gelu.apply(x)
    return F.gelu(x, approximate="tanh")


def _in_place(C, *inputs) -> bool:
    """Whether the mLSTM may write its matrix memory ``C`` in place: not
    while autograd records through it or its inputs, since the products
    of a step save C for backward. Serving (``torch.inference_mode``,
    ``torch.no_grad``) keeps the in-place write."""
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (C,) + inputs))


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, C0, n0, m0, L):
    """Chunkwise-parallel mLSTM: S/L chunk steps, each an (L x L)
    decay-masked attention inside the chunk plus the carried state.

    q,k,v: (B,S,H,dh) (k pre-scaled); i_pre/f_pre: (B,S,H) raw gate logits;
    C0: (B,H,dh,dh) (updated in place unless autograd records),
    n0: (B,H,dh), m0: (B,H) fp32. Returns (h (B,S,H,dh) fp32, (C,n,m))."""
    b, s, h, dh = q.shape
    in_place = _in_place(C0, q, k, v, i_pre, f_pre)
    nc = s // L

    def r4(t):
        return t.float().permute(0, 2, 1, 3).reshape(b, h, nc, L, dh)

    def r3(t):
        return t.float().permute(0, 2, 1).reshape(b, h, nc, L)

    qc, kc, vc = r4(q), r4(k), r4(v)
    ic, fc = r3(i_pre), r3(f_pre)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, n, m = C0, n0, m0
    hs = []
    for idx in range(nc):
        qt, kt, vt = qc[:, :, idx], kc[:, :, idx], vc[:, :, idx]
        it = ic[:, :, idx]
        logf = F.logsigmoid(fc[:, :, idx])
        Fc = torch.cumsum(logf, dim=-1)                   # inclusive (b,h,L)
        Ftot = Fc[..., -1]
        a = it - Fc
        Amax = torch.cummax(a, dim=-1).values
        m_t = Fc + torch.maximum(m[..., None], Amax)      # (b,h,L)
        expo = Fc[..., :, None] + a[..., None, :] - m_t[..., :, None]
        expo = torch.where(tril, expo, -torch.inf)        # mask BEFORE exp
        wmat = torch.exp(expo)
        qk = torch.einsum("bhtd,bhsd->bhts", qt, kt)
        wqk = wmat * qk
        intra_num = torch.einsum("bhts,bhsd->bhtd", wqk, vt)
        intra_den = wqk.sum(dim=-1)
        r = torch.exp(Fc + m[..., None] - m_t)            # (b,h,L)
        inter_num = r[..., None] * torch.einsum("bhtd,bhde->bhte", qt, C)
        inter_den = r * torch.einsum("bhtd,bhd->bht", qt, n)
        num = inter_num + intra_num
        den = inter_den + intra_den
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        m_next = Ftot + torch.maximum(m, Amax[..., -1])
        decay = torch.exp(Ftot + m - m_next)
        wk = torch.exp(a + (Ftot - m_next)[..., None])    # (b,h,L)
        upd = torch.einsum("bht,bhtd,bhte->bhde", wk, kt, vt)
        if in_place:
            C.mul_(decay[..., None, None]).add_(upd)
        else:
            C = C * decay[..., None, None] + upd
        n = decay[..., None] * n + torch.einsum("bht,bhtd->bhd", wk, kt)
        m = m_next
    # (b,h,nc,L,dh) -> (b,s,h,dh)
    out = torch.stack(hs, dim=2).reshape(b, h, s, dh).permute(0, 2, 1, 3)
    return out, (C, n, m)


def _mlstm_sequential(q, k, v, i_pre, f_pre, C, n, m):
    """The reference's step-by-step scan; C (B,H,dh,dh) updated in place
    unless autograd records. Returns (h (B,S,H,dh) fp32, (C,n,m))."""
    in_place = _in_place(C, q, k, v, i_pre, f_pre)
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        it, ft = i_pre[:, t], f_pre[:, t]
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(log_f + m - m_new)
        ik, vr = (i_g[..., None] * kt)[..., :, None], vt[..., None, :]
        if in_place:
            C.mul_(f_g[..., None, None]).addcmul_(ik, vr)
        else:
            C = torch.addcmul(C * f_g[..., None, None], ik, vr)
        n = f_g[..., None] * n + i_g[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        den = torch.clamp(torch.einsum("bhk,bhk->bh", n, qt).abs(), min=1.0)
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def apply_mlstm_block(cfg, p, x, *, state=None):
    """mLSTM with matrix memory. state: {'C': (B,H,dk,dv), 'n': (B,H,dk),
    'm': (B,H)} fp32 and 'conv': (B,K-1,2d); a given C is updated in
    place unless autograd records. Chunkwise-parallel when S % 64 == 0 and S > 64, else the
    sequential scan."""
    b, s, d = x.shape
    h = cfg.num_heads
    inner = 2 * d
    dh = inner // h
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    up = xn @ p["w_up"]
    gate = _silu(xn @ p["w_gate"])
    conv_state = state["conv"] if state is not None else None
    c_out, new_conv = batch_local(
        _causal_conv1d, (up, p["conv_w"], p["conv_b"], conv_state),
        (True, False, False, True))
    c_act = _silu(c_out)
    ch = split_heads(c_act, h, dh, None, h)
    uh = split_heads(up, h, dh, None, h)
    q = torch.einsum("bshk,hkj->bshj", ch, p["wq"])
    k = torch.einsum("bshk,hkj->bshj", ch, p["wk"]) * _const(dh ** -0.5, ch)
    v = torch.einsum("bshk,hkj->bshj", uh, p["wv"])
    if_gates = (c_act @ p["w_if"]).float().reshape(b, s, h, 2)
    i_pre, f_pre = if_gates[..., 0], if_gates[..., 1]

    if state is not None:
        C0, n0, m0 = state["C"], state["n"], state["m"]
    else:
        C0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        m0 = torch.zeros((b, h), dtype=torch.float32, device=x.device)

    chunked = s % MLSTM_CHUNK == 0 and s > MLSTM_CHUNK

    def core(*a):
        hs, st = (_mlstm_chunkwise(*a, MLSTM_CHUNK) if chunked
                  else _mlstm_sequential(*a))
        # the heads merge on each rank's rows: on a mesh the gradient
        # comes back sharded over model, which DTensor cannot split
        # into heads the model axis does not divide
        return hs.reshape(hs.shape[0], s, inner), st

    hs, (C, n, m) = batch_local(core, (q, k, v, i_pre, f_pre, C0, n0, m0),
                                (True,) * 8)
    hs = hs.to(x.dtype)
    out = (hs * gate) @ p["w_down"]
    new_state = None
    if state is not None:
        new_state = {"C": C, "n": n, "m": m, "conv": new_conv}
    seq = "act_q_seq" if chunked else None
    return constrain(x + out, ("batch", seq, None)), new_state


def slstm_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    dt = cfg.torch_dtype
    h = cfg.num_heads
    dh = d // h
    # up-projection ~4/3 * d, rounded to an MXU/TP-friendly multiple of 128
    f = max(128, round(d * 4 / 3 / 128) * 128)
    return {
        "ln": ParamSpec((n, d), ("layers", None), "ones", dt),
        "w_zifo": ParamSpec((n, d, 4 * d), ("layers", "fsdp", "tp"), "normal", dt),
        "r_zifo": ParamSpec((n, h, dh, 4 * dh), ("layers", None, None, None), "normal", dt),
        "w_out": ParamSpec((n, d, d), ("layers", "fsdp", "tp"), "normal", dt),
        "ln2": ParamSpec((n, d), ("layers", None), "ones", dt),
        "mlp_up": ParamSpec((n, d, f), ("layers", "fsdp", "tp"), "normal", dt),
        "mlp_down": ParamSpec((n, f, d), ("layers", "tp_in", "fsdp"), "normal", dt),
    }


def _global_gates(rh):
    """(B, nh, 4dh) per-head gate groups -> (B, 4d) in the global
    [z|i|f|o] layout that matches ``x @ w_zifo``."""
    b, nh, dh4 = rh.shape
    return rh.reshape(b, nh, 4, dh4 // 4).transpose(1, 2).reshape(b, nh * dh4)


def apply_slstm_block(cfg, p, x, *, state=None):
    """sLSTM with exponential gating + normalizer. state: {'h','c','n','m'}
    each (B, d) fp32 (h per-head recurrent via block-diagonal R)."""
    b, s, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    wx = (xn @ p["w_zifo"]).float()  # (B,S,4d)

    if state is not None:
        h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    else:
        h, c, n, m = (torch.zeros((b, d), dtype=torch.float32,
                                  device=x.device) for _ in range(4))

    hs, (h, c, n, m) = batch_local(
        _slstm_scan, (wx, p["r_zifo"].float(), h, c, n, m),
        (True, False, True, True, True, True))
    hs = hs.to(x.dtype)  # (B,S,d)
    x = x + hs @ p["w_out"]
    x = x + (_gelu(L.rms_norm(x, p["ln2"], cfg.norm_eps) @ p["mlp_up"])
             @ p["mlp_down"])
    new_state = None
    if state is not None:
        new_state = {"h": h, "c": c, "n": n, "m": m}
    return constrain(x, ("batch", None, None)), new_state


def _slstm_scan(wx, r, h, c, n, m):
    """The sLSTM's step loop. wx: (B,S,4d) fp32 input pre-activations;
    r: (H, dh, 4dh) fp32; h, c, n, m: (B, d) fp32. Returns (h for every
    step (B,S,d) fp32, (h, c, n, m))."""
    b, s, d4 = wx.shape
    nh = r.shape[0]
    dh = d4 // 4 // nh
    hs = []
    for t in range(s):
        rh = torch.einsum("bhk,hkj->bhj", h.reshape(b, nh, dh), r)
        pre = wx[:, t] + _global_gates(rh)
        z, i_pre, f_pre, o = pre.chunk(4, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        log_f = F.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)
