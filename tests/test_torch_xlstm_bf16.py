"""The xLSTM blocks in bf16 against the JAX package, forward and vjp.

XLA on the CPU rounds every bf16 op to bf16 (its compiled HLO converts
each op's fp32 result back), so the port rounds op by op too. Three
places parted from the reference before:
- ``jax.nn.gelu`` (the sLSTM MLP) is an expansion whose constants are
  rounded to bf16 (a weak-typed scalar) and whose ``x ** 3`` is two
  rounded products; ``F.gelu`` rounds once, with fp32 constants.
- ``k * dh ** -0.5`` (the mLSTM): JAX rounds the scalar to bf16 first;
  PyTorch multiplies by the fp32 constant.
- The vjp of the SiLU and the GELU: JAX's transpose rules associate the
  products in their own order (``(x g) (s (1 - s))`` for the logistic,
  ``c + c th`` for tanh).

``recurrent._Silu`` / ``_Gelu`` are bitwise JAX's forward and vjp in bf16
on 2^16 draws. The blocks are compared with the reference run op by op
(``jax.disable_jit``, the same primitives as its compiled form):
every output and gradient leaf within one bf16 ulp of its largest value
(2^-7 of max |leaf|). Measured, worst leaf over the leaves: sLSTM S 16
0.0059 (0.0103 before), mLSTM S 16 0.0061 (1.11 before, conv_b), mLSTM
S 128 (chunkwise) 0.0056 (0.187 before, dL/dx). The compiled reference
parts from its own op-by-op run by 0.005-0.012 a leaf here (fusions
reassociate fp32 arithmetic): the bar is not against it. A stand-in with
the earlier ``F.gelu``, unrounded constant and SiLU backward must fail.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.common import materialize as jmaterialize
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.models import recurrent as JR
from repro_torch.common import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.models import recurrent as TR

ULP = 2.0 ** -7
CASES = [("slstm", 16), ("mlstm", 16), ("mlstm", 128)]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(seed, n=1 << 16):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 4).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return x, g


def _jax_vjp(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x, jnp.bfloat16))
    (dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    return np.asarray(y, np.float32), np.asarray(dx, np.float32)


def _port_vjp(fn, x, g):
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    y = fn(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).bfloat16())
    return y.detach().float().numpy(), dx.float().numpy()


class _RoundOnceSilu(torch.autograd.Function):
    """The SiLU backward before: ``g s + ((g x) s) (1 - s)`` with
    ``torch.sigmoid``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * s + (g * x) * s * (1 - s)


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activation_forward_and_vjp_bitwise(name):
    jfn = {"gelu": jax.nn.gelu, "silu": jax.nn.silu}[name]
    tfn = {"gelu": TR._gelu, "silu": TR._silu}[name]
    x, g = _draws(0)
    for fn in (jfn, jax.jit(jfn)):
        want = _jax_vjp(fn, x, g)
        got = _port_vjp(tfn, x, g)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activation_stand_in_fails(name):
    """``F.gelu`` (one rounding) and the earlier SiLU backward part from
    JAX's bf16 bits."""
    x, g = _draws(1)
    want = _jax_vjp({"gelu": jax.nn.gelu, "silu": jax.nn.silu}[name], x, g)
    stand_in = {"gelu": lambda t: F.gelu(t, approximate="tanh"),
                "silu": _RoundOnceSilu.apply}[name]
    got = _port_vjp(stand_in, x, g)
    which = 0 if name == "gelu" else 1
    assert (got[which] != want[which]).mean() > 0.05


def _block_runs(kind, s):
    jc = jget_config("xlstm-1.3b").reduce()
    tc = get_config("xlstm-1.3b").reduce()
    jp = jmaterialize(JM.param_specs(jc), jax.random.key(0))
    p = jax.tree.map(lambda a: a[0], jp["superblocks"][kind])
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    g = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    jfn = JR.apply_slstm_block if kind == "slstm" else JR.apply_mlstm_block
    with jax.disable_jit():
        y, vjp = jax.vjp(lambda p, x: jfn(jc, p, x)[0], p,
                         jnp.asarray(x, jnp.bfloat16))
        gp, gx = vjp(jnp.asarray(g, jnp.bfloat16))
    want = {k: np.asarray(v, np.float32)
            for k, v in {"y": y, "x": gx, **gp}.items()}

    def port():
        tp = {k: v.detach().requires_grad_(True) for k, v in params_from_jax(
            jax.device_get(p), device="cpu").items()}
        xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
        tfn = TR.apply_slstm_block if kind == "slstm" else TR.apply_mlstm_block
        yt = tfn(tc, tp, xt)[0]
        grads = torch.autograd.grad(yt, list(tp.values()) + [xt],
                                    torch.from_numpy(g).bfloat16())
        got = {"y": yt, "x": grads[-1], **dict(zip(tp, grads[:-1]))}
        return {k: v.detach().float().numpy() for k, v in got.items()}

    return want, port


def _worst(got, want):
    return max((float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()),
                k) for k in want)


@pytest.mark.parametrize("kind,s", CASES)
def test_block_bf16_within_an_ulp_of_reference(kind, s):
    want, port = _block_runs(kind, s)
    err, leaf = _worst(port(), want)
    print(f"{kind} S {s}: worst leaf {leaf} at {err:.4g} of its max")
    assert err <= ULP, (leaf, err)


@pytest.mark.parametrize("kind,s", CASES)
def test_block_bf16_stand_in_fails(kind, s, monkeypatch):
    """The earlier port: ``F.gelu``, the fp32 constant, the SiLU backward
    in another order."""
    monkeypatch.setattr(TR, "_gelu", lambda t: F.gelu(t, approximate="tanh"))
    monkeypatch.setattr(TR, "_const", lambda c, like: c)
    monkeypatch.setattr(TR, "_Silu", _RoundOnceSilu)
    want, port = _block_runs(kind, s)
    err, leaf = _worst(port(), want)
    assert err > ULP, (leaf, err)


def test_constants_round_to_the_dtype():
    x = torch.ones(1, dtype=torch.bfloat16)
    assert TR._const(0.044715, x) == 0.044677734375
    assert TR._const(math.sqrt(2 / math.pi), x) == 0.796875
    assert TR._const(0.044715, x.float()) == float(np.float32(0.044715))


# ---------------------------------------------------------------------------
# The sLSTM step's fp32 ops against XLA's, one op at a time (ROADMAP §C)
# ---------------------------------------------------------------------------


def _ulps(a, b):
    """(largest distance in fp32 ulps, elements that differ)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()), int((a != b).sum())


def test_slstm_step_fp32_ops_against_xla():
    """The setup of ``test_loss_decreases_bf16_xlstm``: the JAX package's
    weights at ``reduce()``, the trainer's first batch (2 x 32), the first
    sLSTM block's fp32 step loop, teacher-forced from the JAX package's op
    by op state at every step. Measured against that op by op run: the
    port's recurrent product and pre-activations are bitwise; its
    elementwise functions part by a few fp32 ulps (torch's tanh, sigmoid,
    log-sigmoid and exp are not XLA's approximations: tanh by up to 4
    ulps in about half the elements), and the state by up to 2,048 ulps
    in c. The compiled step parts from the same op by op run more: in
    the recurrent product already (its fusion sums in another order) and
    by up to 6,144 ulps in c. The stabilised gates' exp and log alone are
    the same bits compiled and op by op; ``a * b + c * d``, the form of
    the state updates, is not (XLA's fusion contracts it into fused
    multiply-adds). The JAX package run op by op rises over the 3 steps
    as the port does, so the port cannot follow the compiled trajectory
    op by op: ROADMAP §C, "Conditioning, measured"."""
    from repro.models import layers as JL
    from repro_torch.data.pipeline import TokenPipeline

    b, s = 2, 32
    cfg = get_config("xlstm-1.3b").reduce()
    jc = jget_config("xlstm-1.3b").reduce()
    jp = jmaterialize(JM.param_specs(jc), jax.random.key(0))
    toks = TokenPipeline(cfg, b, s).next_batch()["tokens"]
    p = jax.tree.map(lambda a: a[0], jp["superblocks"]["slstm"])
    x = jnp.take(jp["embed"], jnp.asarray(toks), axis=0)
    with jax.disable_jit():
        wx = (JL.rms_norm(x, p["ln"], jc.norm_eps) @ p["w_zifo"]).astype(
            jnp.float32)
    r = p["r_zifo"].astype(jnp.float32)
    d, nh = jc.d_model, jc.num_heads
    dh = d // nh

    def ops_jax(h, c, n, m, w):
        rh = jnp.einsum("bhk,hkj->bhj", h.reshape(b, nh, dh), r)
        pre = w + rh.reshape(b, nh, 4, dh).transpose(0, 2, 1, 3).reshape(
            b, 4 * d)
        z, i_pre, f_pre, o = jnp.split(pre, 4, axis=-1)
        z, o = jnp.tanh(z), jax.nn.sigmoid(o)
        log_f = jax.nn.log_sigmoid(f_pre)
        m_new = jnp.maximum(log_f + m, i_pre)
        i_g = jnp.exp(i_pre - m_new)
        f_g = jnp.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / jnp.maximum(jnp.abs(n), 1.0)
        return dict(pre=pre, z=z, o=o, log_f=log_f, m=m_new, i_g=i_g,
                    f_g=f_g, c=c, n=n, h=h)

    def ops_port(h, c, n, m, w):
        rt = torch.from_numpy(np.asarray(r))
        rh = torch.einsum("bhk,hkj->bhj", h.reshape(b, nh, dh), rt)
        pre = w + TR._global_gates(rh)
        z, i_pre, f_pre, o = pre.chunk(4, dim=-1)
        z, o = torch.tanh(z), torch.sigmoid(o)
        log_f = F.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / torch.clamp(n.abs(), min=1.0)
        return dict(pre=pre, z=z, o=o, log_f=log_f, m=m_new, i_g=i_g,
                    f_g=f_g, c=c, n=n, h=h)

    compiled = jax.jit(ops_jax)
    port, fused = {}, {}
    state = [jnp.zeros((b, d), jnp.float32) for _ in range(4)]
    for t in range(s):
        with jax.disable_jit():
            eager = ops_jax(*state, wx[:, t])
        got = ops_port(*[torch.from_numpy(np.array(v)) for v in state],
                       torch.from_numpy(np.array(wx[:, t])))
        comp = compiled(*state, wx[:, t])
        for k in eager:
            for out, other in ((port, got[k].numpy()), (fused, comp[k])):
                u, nd = _ulps(eager[k], other)
                was = out.get(k, (0, 0))
                out[k] = (max(was[0], u), was[1] + nd)
        state = [eager["h"], eager["c"], eager["n"], eager["m"]]
    print("port vs op by op", port)
    print("compiled vs op by op", fused)
    assert port["pre"] == (0, 0)
    assert port["z"][0] <= 4 and port["o"][0] <= 2 and port["log_f"][0] <= 2
    # the compiled step parts already in the recurrent product, and in
    # the state more than the port does
    assert fused["pre"][1] > 0
    for k in ("c", "h"):
        assert fused[k][0] > port[k][0], (k, fused[k], port[k])

    # the stabilised gates alone (log-sigmoid, max, exp), on the last
    # step's own pre-activations: the same bits compiled and op by op
    def gates(f_pre, m, i_pre):
        log_f = jax.nn.log_sigmoid(f_pre)
        m_new = jnp.maximum(log_f + m, i_pre)
        return log_f, m_new, jnp.exp(i_pre - m_new), jnp.exp(log_f + m
                                                             - m_new)

    _, i_pre, f_pre, _ = jnp.split(eager["pre"], 4, axis=-1)
    with jax.disable_jit():
        plain = gates(f_pre, state[3], i_pre)
    for a, b in zip(plain, jax.jit(gates)(f_pre, state[3], i_pre)):
        assert _ulps(a, b) == (0, 0)
    # and a * b + c * d, which the compiled fusion contracts into fused
    # multiply-adds
    rng = np.random.default_rng(0)
    a = [jnp.asarray(rng.standard_normal(4096).astype(np.float32))
         for _ in range(4)]

    def fma(a, b, c, d):
        return a * b + c * d

    with jax.disable_jit():
        plain = np.asarray(fma(*a))
    assert (np.asarray(jax.jit(fma)(*a)) != plain).mean() > 0.1
