"""The bf16 fused pre-LN FF against kanvit's on bf16 dots.

kanvit's fused FF (``KANVIT_FF=1``) on bf16 operands (its ``_dot_dtype``)
computes LN in f32, rounds it to bf16 at the first dot, adds b1 in f32,
rounds relu(h) at the second dot and y once; its backward rounds r and dh
at their dots, sums every parameter gradient in f32 over its row blocks
(``_bn``) and rounds each once. The port's plain twins
(``K.ffn_pre_ln_bf16``, ``K.ffn_pre_ln_bwd_bf16``) follow that policy; here
they are held against kanvit's Pallas kernels in interpret mode
(``dispatch.set_impl("pallas")``, ``KANVIT_FF_BN=8`` so that several row
blocks accumulate) on the same bf16 inputs, drawn with numpy from a seed.
The gates, stated before any run: the forward equal in every element; each
gradient within one bf16 ulp elementwise, |a - b| <= 2^-7 |b| + 2^-12
max|b|, plus one bf16 ulp of each rounded intermediate weighted as the next
product weighs it, 2^-8 of ``K.ffn_spread_bf16`` (LN's, r's and dh's), and
for the sums over the rows in other blocks than kanvit's 2 N 2^-24 of their
sum of |terms|.

- the twins against kanvit's ``_ffn_op`` and its VJP, dtypes included;
- the CPU route's fault and its repair: a bf16 ``ffn_pre_ln`` on CPU tensors
  ran the f32 plain version in bf16 torch ops, rounding h, h + b1, the
  second product, + b2 and + x each to bf16 (most of y's elements differ
  from kanvit's); it now runs the twins (none differs);
- mixed dtypes raise;
- the card route's wrapper (``_FfnFn`` on bf16, its pitches, scratch, row
  splits and dtypes) with the kernel library replaced by an emulation of
  the kernels' arithmetic on the tensors behind its pointers, at a ragged
  D, at two row splits and past D 512 (the tiled route);
- a 2-block efficientkan ViT with ``fused_ff=True`` in bf16 against
  kanvit's bf16 ``apply`` under ``KANVIT_FF=1`` on kanvit's converted
  weights (logits within 2e-2 x max(1, max|logits|)), and 3 bf16 training
  steps against kanvit's (losses 2e-2 x max(1, |loss|), step-1 gradients
  5e-2 x max(1, max|g|), the FF's own 5e-2 of each tensor's own max|g|,
  parameters within 2 K lr).

Small shapes; torch on one thread.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.kernels import fused_ffn as JFFN
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.train.state import create_train_state as j_create_train_state
from kanvit.train.steps import make_train_step as j_make_train_step
from kanvit_torch.kernels import _build
from kanvit_torch.kernels import fused_ffn as FFN
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.train import create_train_state, make_eval_step, make_train_step
from kanvit_torch.utils import precision
from kanvit_torch.utils.convert import load_reference_state_dict, state_dict_from_jax_params
from test_torch_port_train import _adam_state

BF16 = torch.bfloat16
ULP_REL, ULP_ABS, ULP_MID = 2.0 ** -7, 2.0 ** -12, 2.0 ** -8
GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)
LOGIT_TOL = 2e-2  # x max(1, max|logits|), kanvit's bf16 gate
LOSS_TOL = 2e-2   # x max(1, |loss|)
GRAD_TOL = 5e-2   # x max(1, max|g|), kanvit's bf16 gate; the FF's own: x own max|g|
LR, K_STEPS = 1e-3, 3


@pytest.fixture(autouse=True)
def one_thread_pallas(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("KANVIT_FF", "1")
    monkeypatch.setenv("KANVIT_FF_BN", "8")
    jdispatch.set_impl("pallas")
    FFN.reset_launches()
    yield
    jdispatch.set_impl("auto")
    torch.set_num_threads(threads)


def _case(seed, n, d, f):
    """``chip_smoke.py``'s operand scales at (n, d, f), rounded to bf16:
    ``(torch tensors, jax arrays, g torch, g jax)``."""
    rng = np.random.default_rng(seed)
    shapes = ((n, d), (d,), (d,), (f, d), (f,), (d, f), (d,))
    scales = (1.0, 0.3, 0.1, d ** -0.5, 0.1, f ** -0.5, 0.1)
    arrays = [rng.standard_normal(s) * sc for s, sc in zip(shapes, scales)]
    arrays[1] += 1.0
    ts = [torch.from_numpy(np.asarray(a, np.float32)).to(BF16) for a in arrays]
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(BF16)
    return ts, [_jax(t) for t in ts], g, _jax(g)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _gate(got, want, spread):
    """One bf16 ulp of the output plus 2^-8 of ``spread``."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    bound = ULP_REL * np.abs(want) + ULP_ABS * np.abs(want).max() + ULP_MID * _f64(spread)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= bound).all(), float((err - bound).max())


def _kanvit(js, jg):
    """kanvit's ``_ffn_op`` forward and its seven gradients."""
    y, vjp = jax.vjp(JFFN._ffn_op, *js)
    return y, vjp(jg)


@pytest.mark.parametrize("n,d,f,equal", [(64, 32, 128, True), (37, 24, 48, True),
                                         (200, 136, 264, False)])
def test_twins_match_kanvit_kernel(n, d, f, equal):
    """The twins at kanvit's row blocks (8 here): y bf16 as kanvit's, equal
    in every element (deeper sums, D 136 and F 264, in torch's order and
    XLA's round a few y to the neighbouring bf16: there y is held to its
    gate); every gradient bf16 and within its gate."""
    ts, js, g, jg = _case(100 + d, n, d, f)
    want, jgrads = _kanvit(js, jg)
    got = K.ffn_pre_ln_bf16(*ts)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    if equal:
        assert int((_f64(got) != _f64(want)).sum()) == 0
    else:
        _gate(got, want, K.ffn_spread_bf16(*ts[:6]))
    grads = K.ffn_pre_ln_bwd_bf16(*ts[:6], g, block=8)
    for name, a, b, sp in zip(GRADS, grads, jgrads, K.ffn_spread_bf16(*ts[:6], g=g)):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16, name
        _gate(a, b, sp)


def test_cpu_route_fault_and_repair():
    """A bf16 ``ffn_pre_ln`` on CPU tensors: the old route (the f32 plain
    version in bf16 torch ops, each of h, h + b1, the second product, + b2
    and + x rounded to bf16) differs from kanvit's kernel in most of y's
    elements; the port's CPU route (the twins) in none, and its gradients
    (autograd through ``_FfnBf16Plain``, 512-row blocks) lie within the gate
    of kanvit's over 8-row blocks."""
    n, d, f = 64, 32, 128
    ts, js, g, jg = _case(7, n, d, f)
    want, jgrads = _kanvit(js, jg)
    before = int((_f64(K.ffn_pre_ln(*ts)) != _f64(want)).sum())
    assert before > want.size // 4, before
    leaves = [t.clone().requires_grad_(True) for t in ts]
    got = FFN.ffn_pre_ln(*leaves)
    assert got.dtype == BF16 and int((_f64(got) != _f64(want)).sum()) == 0
    grads = torch.autograd.grad(got, leaves, g)
    for name, a, b, sp in zip(GRADS, grads, jgrads, K.ffn_spread_bf16(*ts[:6], g=g)):
        assert a.dtype == BF16, name
        _gate(a, b, sp)
    assert not any(FFN.LAUNCHES.values())


def test_mixed_dtypes_raise(monkeypatch):
    """All seven tensors f32 or all bf16: a mixed call raises ``TypeError``
    naming the tensor, its dtype and x's, on the CPU and on the card's route
    before any launch."""
    ts, _, _, _ = _case(8, 10, 16, 32)
    mixed = [ts[0].float(), *ts[1:]]
    with pytest.raises(TypeError, match="gamma must be float32 as x is, got torch.bfloat16"):
        FFN.ffn_pre_ln(*mixed)
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    with pytest.raises(TypeError, match="w2 must be bfloat16 as x is, got torch.float32"):
        FFN.ffn_pre_ln(*ts[:5], ts[5].float(), ts[6])
    assert not any(FFN.LAUNCHES.values())


# --- the card route's wrapper, the kernels emulated behind its pointers --------

class _FakeKernels:
    """The bf16 entry points of ``csrc/fused_ffn_bf16.cu`` on CPU tensors:
    each pointer is looked up among the tensors whose ``data_ptr`` the
    wrapper took, every layout the kernels assume is asserted (pitches of 8
    bf16, zero pad columns, the scratch shapes, the row splits), and the
    kernels' arithmetic is emulated: LN rounded to bf16, h and dr over D, y
    over 256-unit chunks of F in one f32 running sum, r and dh rounded,
    db1 over 64-row blocks, dgamma and dbeta over 48-row blocks, dW over
    the row splits, each sum in f32 in its fixed order, one rounding."""

    def __init__(self, registry):
        self.reg = registry

    def _t(self, p, shape, dtype):
        t = self.reg[p]
        assert tuple(t.shape) == tuple(shape) and t.dtype == dtype, (t.shape, shape, t.dtype)
        assert t.is_contiguous()
        return t

    def _weights(self, w1, w2, d, f, ldd, ldf):
        assert ldd == -(-d // 8) * 8 and ldf == -(-f // 8) * 8
        w1t, w2t = self._t(w1, (f, ldd), BF16), self._t(w2, (d, ldf), BF16)
        assert w1t.data_ptr() % 16 == 0 and w2t.data_ptr() % 16 == 0
        assert not w1t[:, d:].any() and not w2t[:, f:].any()
        return w1t[:, :d].float(), w2t[:, :f].float()

    def _vectors(self, n, d, f, x, gamma, beta, b1):
        return (self._t(x, (n, d), BF16), self._t(gamma, (d,), BF16),
                self._t(beta, (d,), BF16), self._t(b1, (f,), BF16))

    @staticmethod
    def _ln(xt, gt, bt):
        xhat, ln, rstd = K._ln_f32(xt, gt, bt)
        return xhat, ln.to(BF16), rstd

    def _forward(self, x, gamma, beta, w1, b1, w2, b2, y, mask, n, d, f, ldd, ldf, ln=None):
        xt, gt, bt, b1t = self._vectors(n, d, f, x, gamma, beta, b1)
        w1f, w2f = self._weights(w1, w2, d, f, ldd, ldf)
        _, lnd, _ = self._ln(xt, gt, bt)
        if ln is not None:
            ln.zero_()[:, :d] = lnd
        h = lnd.float() @ w1f.T + b1t.float()
        if mask:
            self._t(mask, (n, f), torch.uint8).copy_(h > 0)
        r = torch.relu(h).to(BF16).float()
        acc = torch.zeros(n, d)
        for c0 in range(0, f, 256):
            acc = acc + r[:, c0:c0 + 256] @ w2f[:, c0:c0 + 256].T
        out = (acc + self._t(b2, (d,), BF16).float()) + xt.float()
        self._t(y, (n, d), BF16).copy_(out.to(BF16))
        return r

    def kanvit_ffn_fwd_bf16(self, x, gamma, beta, w1, b1, w2, b2, y, mask, n, d, f, ldd,
                            ldf, stream):
        assert 1 <= d <= FFN.FUSED_MAX_D
        self._forward(x, gamma, beta, w1, b1, w2, b2, y, mask, n, d, f, ldd, ldf)
        return 0

    def kanvit_ffn_fwd_wide_bf16(self, x, gamma, beta, w1, b1, w2, b2, y, mask, ln, stats, r,
                                 n, d, f, ldd, ldf, stream):
        assert d > FFN.FUSED_MAX_D
        self._t(stats, (n, 2), torch.float32)
        rt = self._forward(x, gamma, beta, w1, b1, w2, b2, y, mask, n, d, f, ldd, ldf,
                           ln=self._t(ln, (n, ldd), BF16))
        self._t(r, (n, ldf), BF16).zero_()[:, :f] = rt.to(BF16)
        return 0

    def kanvit_ffn_bwd_bf16(self, x, g, gamma, beta, w1, w2, b1, dx, dgb, dw1, db1, dw2, db2,
                            ln, stats, r, dh, dgb_part, db1_part, dln, dw1_part, dw2_part,
                            db2_part, n, d, f, ldd, ldf, splits, stream):
        xt, gt, bt, b1t = self._vectors(n, d, f, x, gamma, beta, b1)
        w1f, w2f = self._weights(w1, w2, d, f, ldd, ldf)
        gg = self._t(g, (n, ldd), BF16)
        assert not gg[:, d:].any() and splits == FFN.dw_splits(n, d, f)
        g32 = gg[:, :d].float()
        xhat, lnd, rstd = self._ln(xt, gt, bt)
        lns = self._t(ln, (n, ldd), BF16)
        lns.zero_()[:, :d] = lnd
        self._t(stats, (n, 2), torch.float32)
        h = lnd.float() @ w1f.T + b1t.float()
        dhf = torch.where(h > 0, g32 @ w2f, 0.0)
        rt, dht = self._t(r, (n, ldf), BF16), self._t(dh, (n, ldf), BF16)
        rt.zero_()[:, :f] = torch.relu(h).to(BF16)
        dht.zero_()[:, :f] = dhf.to(BF16)
        parts = self._t(db1_part, (-(-n // FFN.HIDDEN_ROWS_BF16), f), torch.float32)
        for i, r0 in enumerate(range(0, n, FFN.HIDDEN_ROWS_BF16)):
            parts[i] = dhf[r0:r0 + FFN.HIDDEN_ROWS_BF16].sum(0)
        dlnp = dht[:, :f].float() @ w1f
        if d > FFN.FUSED_MAX_D:
            self._t(dln, (n, ldd), torch.float32).zero_()[:, :d] = dlnp
        else:
            assert dln is None
        gs = dlnp * gt.float()
        dxt = g32 + rstd * (gs - gs.sum(1, keepdim=True) / d
                            - xhat * (gs * xhat).sum(1, keepdim=True) / d)
        self._t(dx, (n, d), BF16).copy_(dxt.to(BF16))
        blocks = self._t(dgb_part, (-(-n // FFN.ROWS_PER_BLOCK), 2, d), torch.float32)
        for i, r0 in enumerate(range(0, n, FFN.ROWS_PER_BLOCK)):
            rows = slice(r0, r0 + FFN.ROWS_PER_BLOCK)
            blocks[i, 0] = (dlnp[rows] * xhat[rows]).sum(0)
            blocks[i, 1] = dlnp[rows].sum(0)
        self._t(dgb, (2, d), BF16).copy_(self._ordered(blocks).to(BF16))
        self._t(db1, (f,), BF16).copy_(self._ordered(parts).to(BF16))
        per = -(-n // splits)
        spans = [slice(lo, min(n, lo + per)) for lo in range(0, splits * per, per)]
        p2 = self._t(dw2_part, (splits, d, f), torch.float32)
        pb2 = self._t(db2_part, (splits, d), torch.float32)
        p1 = self._t(dw1_part, (splits, f, d), torch.float32)
        for s, rows in enumerate(spans):
            p2[s] = g32[rows].T @ rt[rows, :f].float()
            pb2[s] = g32[rows].sum(0)
            p1[s] = dht[rows, :f].float().T @ lns[rows, :d].float()
        self._t(dw2, (d, f), BF16).copy_(self._ordered(p2).to(BF16))
        self._t(db2, (d,), BF16).copy_(self._ordered(pb2).to(BF16))
        self._t(dw1, (f, d), BF16).copy_(self._ordered(p1).to(BF16))
        return 0

    @staticmethod
    def _ordered(parts):
        total = torch.zeros_like(parts[0])
        for p in parts:
            total = total + p
        return total


@pytest.fixture
def kernel_route(monkeypatch):
    """``ffn_pre_ln``'s card route on CPU tensors, the library emulated."""
    registry, data_ptr = {}, torch.Tensor.data_ptr

    def remembered(t):
        p = data_ptr(t)
        registry[p] = t
        return p

    monkeypatch.setattr(torch.Tensor, "data_ptr", remembered)
    monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
    monkeypatch.setattr(_build, "load", lambda: _FakeKernels(registry))
    monkeypatch.setattr(FFN, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())


@pytest.mark.parametrize("n,d,f", [
    (53, 100, 400),  # ragged N, D and F padded to pitches of 8, two chunks of F
    (520, 16, 40),   # two row splits of the weight gradients, 11 row blocks
    (12, 768, 512),  # past D 512: the tiled route (vit-b's D)
])
def test_kernel_route_matches_kanvit(kernel_route, n, d, f):
    """``_FfnFn`` on bf16 through the emulated kernels: y and the seven
    gradients bf16, within their gates of kanvit's kernel; one bf16 launch
    each way and no f32 one; the wrapper's relu_mask hook the backward's
    pattern."""
    ts, js, g, jg = _case(130 + d, n, d, f)
    want, jgrads = _kanvit(js, jg)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    got = FFN.ffn_pre_ln(*leaves)
    grads = torch.autograd.grad(got, leaves, g)
    assert got.dtype == BF16
    _gate(got, want, K.ffn_spread_bf16(*ts[:6]))
    for name, a, b, sp in zip(GRADS, grads, jgrads, K.ffn_spread_bf16(*ts[:6], g=g)):
        assert a.dtype == BF16 and a.shape == ts[GRADS.index(name)].shape, name
        _gate(a, b, sp)
    assert FFN.LAUNCHES == {"ffn_pre_ln": 0, "ffn_pre_ln_bwd": 0, "ffn_pre_ln_bf16": 1,
                            "ffn_pre_ln_bwd_bf16": 1}
    mask = torch.empty(n, f, dtype=torch.uint8)
    FFN._launch_bf16(*ts, relu_mask=mask)
    _, ln, _ = K._ln_f32(*ts[:3])
    assert torch.equal(mask.bool(), ln.to(BF16).float() @ ts[3].float().T + ts[4].float() > 0)


# --- the slice: a fused-FF ViT in bf16 against kanvit's ---------------------------

def _kanvit_vit(seed=6):
    """kanvit's 2-block efficientkan ViT (MNIST geometry), its weights."""
    jmodel = j_create_model("efficientkan", **SMALL)
    jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
    try:
        state = j_create_train_state(jmodel, jax.random.PRNGKey(seed),
                                     jnp.zeros((1, *SMALL["chw"])))
    finally:
        jdispatch.set_impl("pallas")
    return jmodel, state


def _port_vit(params):
    model = create_model("efficientkan", **SMALL, seed=9, fused_ff=True)
    load_reference_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)))
    return model


def test_fused_ff_vit_bf16_matches_kanvit_apply():
    """On kanvit's converted weights: the port's bf16 forward (a
    ``cast_params_`` copy, and ``make_eval_step(bf16=True)``) against
    kanvit's bf16 ``apply`` with ``KANVIT_FF=1``, logits within 2e-2 x
    max(1, max|logits|); the FF's Linears never run."""
    jmodel, state = _kanvit_vit()
    x = np.random.default_rng(74).standard_normal((3, *SMALL["chw"])).astype(np.float32)
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if p.dtype == jnp.float32 else p,
                          state.params)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32), np.float64)
    model = _port_vit(state.params)
    calls = []
    for blk in model.blocks:
        assert blk.fused_ff
        blk.ff.register_forward_pre_hook(lambda *a: calls.append(1))
    limit = LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    _, logits = make_eval_step(bf16=True)(create_train_state(model), torch.from_numpy(x),
                                          torch.zeros(3, dtype=torch.long))
    assert logits.dtype == torch.float32
    assert float(np.abs(logits.double().numpy() - want).max()) <= limit
    served = precision.cast_params_(_port_vit(state.params))
    with torch.inference_mode():
        got = served(torch.from_numpy(x).to(BF16)).float()
    assert float(np.abs(got.double().numpy() - want).max()) <= limit
    assert not calls


def test_fused_ff_bf16_train_steps_match_kanvit():
    """3 bf16 training steps (Adam 1e-3, 8 images a step) of the port and
    kanvit from the same weights: each loss within 2e-2 x max(1, |loss|),
    the step-1 gradients within kanvit's bf16 gate, 5e-2 x max(1, max|g|),
    and the fused FF's own (norm2, ff.0, ff.2) within 5e-2 of each tensor's
    own max|g| (kanvit's from Adam's first moment after one step, as
    ``run_steps`` takes them; elsewhere the two frameworks' bf16 models
    round apart, up to 12% of a LayerNorm weight's own max, a sum over the
    tokens that cancels), every parameter after 3 steps within 2 K lr of
    kanvit's."""
    jmodel, state = _kanvit_vit(seed=4)
    rng = np.random.default_rng(75)
    xs = rng.standard_normal((K_STEPS, 8, *SMALL["chw"])).astype(np.float32)
    ys = rng.integers(0, SMALL["out_d"], (K_STEPS, 8))
    model = _port_vit(state.params)
    step = j_make_train_step(bf16=True, donate=False)
    jlosses, jgrads = [], None
    for x, y in zip(xs, ys):
        state, loss, _ = step(state, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(loss))
        if jgrads is None:
            jgrads = state_dict_from_jax_params(jax.tree.map(
                lambda m: np.asarray(m) / 0.1, _adam_state(state.opt_state).mu))
    tstate, tstep = create_train_state(model, LR), make_train_step(bf16=True)
    for i, (x, y) in enumerate(zip(xs, ys)):
        tstate, loss, _ = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(loss) - jlosses[i]) <= LOSS_TOL * max(1.0, abs(jlosses[i]))
        if i == 0:
            for name, p in model.named_parameters():
                want = np.asarray(jgrads[name], np.float64)
                assert p.grad.dtype == torch.float32, name
                err = float(np.abs(p.grad.double().numpy() - want).max())
                scale = float(np.abs(want).max())
                own = any(part in name for part in (".norm2.", ".ff.0.", ".ff.2."))
                assert err <= GRAD_TOL * (scale if own else max(1.0, scale)), (name, err)
    jparams = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        diff = float(np.abs(p.detach().double().numpy() - jparams[name]).max())
        assert diff <= 2 * K_STEPS * LR, (name, diff)


def test_check_bf16_trainable_passes_fused_ff():
    """Every model passes: the efficientkan and fourier ViTs with the fused
    FF among them."""
    for kind in ("efficientkan", "fourier", "vanilla"):
        precision.check_bf16_trainable(create_model(kind, **SMALL, seed=3, fused_ff=True))
