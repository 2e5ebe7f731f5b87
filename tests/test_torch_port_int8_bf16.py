"""int8 serving of a bf16 model against kanvit's, both of its routes.

kanvit serves a bf16 tree in int8 (``benchmarks/inference_serving.py --bf16
--quant int8``) on two routes with two dtype flows, held here against the
port on the same bf16 weights (a port model's f32 weights rounded to bf16,
carried across) and the same bf16 images, drawn with numpy from a seed,
kanvit under forced Pallas in interpret mode:

- the qdot route (``KANVIT_INT8_KERNEL=0``; ``Predictor(int8_kernel=False)``):
  ``qdot`` returns f32, so the first int8 Linear turns the stream f32 (the
  vanilla and flash-attn embedder, a KAN ViT's first FF) and every later
  layer runs in f32 on widened bf16 weights;
- the kernel route (kanvit's forced Pallas; ``int8_kernel=True``):
  ``int8_linear`` returns x's dtype, so the stream stays bf16 up to the
  head, whose 10 classes take ``qdot`` and give f32 logits.

The gates, stated before any run:

- ``int8_linear`` on bf16 x against kanvit's kernel on a multi-block grid:
  bf16 out, within the tie-aware bound of ``tests/test_quant.py`` plus one
  bf16 rounding of each side (2^-8 max|y|), and bit-equal to the port's
  bf16 twin (``qdot_rowwise`` rounded once), through the plain route and
  the emulated launch;
- the dtype flow: the embedder's, each block's and the logits' dtype (port:
  forward hooks; kanvit: ``flax.linen.intercept_methods``) equal, both
  routes;
- ``Predictor(quant="int8")`` on the bf16 model against kanvit's int8
  ``Predictor`` on the bf16 tree: logits within 2e-2 x max(1, max|logit|)
  (the bf16 serving gate), on the qdot route for all seven ViT kinds, the
  kernel route for vanilla, efficientkan and flash-attn, calibrated for
  vanilla, and the fused-FF vanilla on the qdot route; and kanvit's int8
  gates against the same bf16 model's float logits: top-1 agreement at
  least 0.9, no probability moved by 0.2 or more;
- the emulated card route's launches, exactly: bf16 ``int8_linear`` on the
  kernel route (the embedder and two a block; flash-attn's three
  projections a block), none on the qdot route, and the attention in the
  stream's dtype;
- ``precision.promote``'s rule, the layers' widening bit for bit, and the
  kernel wrappers still refusing mixed dtypes.

Small shapes (2 blocks; d 128 where the kernel route needs multiples of
128, d 32 elsewhere); torch on one thread.
"""

import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanvit.infer import Predictor as JPredictor
from kanvit.kernels import int8_matmul as JIM
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit_torch.infer import Predictor
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.kernels import fused_basis as FB
from kanvit_torch.kernels import fused_ffn as FFN
from kanvit_torch.kernels import int8_matmul as IM
from kanvit_torch.layers import (
    ChebyKANLayer,
    FastKANLayer,
    FourierKANLayer,
    KANLinear,
    SineKANLayer,
    TorchLinear,
)
from kanvit_torch.layers.transformer import LayerNorm
from kanvit_torch.models import create_model
from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K
from kanvit_torch.ops import quant as Q
from kanvit_torch.utils import precision
from kanvit_torch.utils.convert import scales_from_jax
from test_torch_port_bf16 import _emu_kan_bf16, _emu_lanes_bf16
from test_torch_port_kernels import _emu_fwd
from test_torch_port_ffn_int8 import (
    INT8_GEOM,
    _emulate_launches,
    _quant_step_bound,
    _vit_params,
    _xw,
)

BF16 = torch.bfloat16
LOGIT_TOL = 2e-2   # x max(1, max|logits|): the bf16 serving gate
SCALE_TOL = 2e-2   # calibrated scales, relative: a bf16 forward's maxima
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)
KINDS = ("vanilla", "efficientkan", "fast", "sine", "fourier", "cheby", "flash-attn")
KERNEL_KINDS = ("vanilla", "efficientkan", "flash-attn")
BATCH, IMAGES = 8, 20


@pytest.fixture(autouse=True)
def one_thread_pallas():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jdispatch.set_impl("pallas")
    for module in (FB, FA, FFN, IM):
        module.reset_launches()
    yield
    jdispatch.set_impl("auto")
    torch.set_num_threads(threads)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _emu_kan(name, family, x2d, w, aux):
    """The KAN forward kernels: bf16 x to the (emulated) bf16 launch, as
    ``FB._launch`` routes it, f32 x emulated."""
    if x2d.dtype == BF16:
        return FB._launch_bf16(name, x2d, w, aux)
    return _emu_fwd(name, family, x2d, w, aux)


def _emulate_card(monkeypatch):
    """The CUDA route's wrappers on the CPU, each launch emulated: f32 and
    bf16 ``int8_linear``, the lanes attention and the B-spline, Chebyshev
    and Fourier forwards in f32 and bf16."""
    _emulate_launches(monkeypatch)
    monkeypatch.setattr(FA, "_launch_bf16", _emu_lanes_bf16)
    monkeypatch.setattr(FB, "_launch_bf16", _emu_kan_bf16)
    monkeypatch.setattr(FB, "_launch", _emu_kan)


@pytest.fixture(params=["plain", "kernel_math"])
def int8_path(request, monkeypatch):
    if request.param == "kernel_math":
        _emulate_card(monkeypatch)
    return request.param


# --- int8_linear on bf16 x ------------------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_linear_bf16_matches_kanvit_kernel(int8_path, monkeypatch, with_bias):
    """kanvit's kernel in interpret mode on a multi-block grid (64-row,
    128-output blocks, the weight not resident), bf16 x, W and bias, against
    the port's: bf16 out within the tie-aware bound plus a bf16 rounding of
    each side, and the bits of the bf16 twin."""
    monkeypatch.setattr(JIM, "_BN", 64)
    monkeypatch.setattr(JIM, "_BO", 128)
    monkeypatch.setattr(JIM, "_W_RESIDENT_BYTES", 0)
    x, w, b = (torch.from_numpy(a).to(BF16) for a in _xw(90))
    b = b if with_bias else None
    jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, w))
    jb = None if b is None else jnp.asarray(b.float().numpy()).astype(jnp.bfloat16)
    want = JIM.int8_linear(jx, jw, bias=jb)
    got = IM.int8_linear(x, w, b)
    assert want.dtype == jnp.bfloat16
    assert got.dtype == BF16 and got.shape == (100, 384)
    want = np.asarray(want.astype(jnp.float32))
    limit = (_quant_step_bound(x.float().numpy(), w.float().numpy())
             + 2.0 ** -8 * float(np.abs(want).max()))
    assert _maxdiff(got.float(), want) <= limit
    twin = Q.qdot_rowwise(x, w, b)
    assert twin.dtype == torch.float32
    assert torch.equal(got, twin.to(BF16))
    assert IM.LAUNCHES == {"int8_linear": 0,
                           "int8_linear_bf16": int(int8_path == "kernel_math")}


def test_int8_linear_bf16_bits_on_leading_dims(monkeypatch):
    """(B, T, K) bf16 x with ragged rows: the emulated launch and the plain
    route give the same bits, and each equals the f32 epilogue of the
    values widened, rounded once."""
    rng = np.random.default_rng(91)
    x = torch.from_numpy(rng.standard_normal((3, 37, 256)).astype(np.float32)).to(BF16)
    w = torch.from_numpy((rng.standard_normal((128, 256)) * 0.05).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32)).to(BF16)
    plain = IM.int8_linear(x, w, b)
    want = Q.qdot_rowwise(x.float(), w.float(), b.float()).to(BF16)
    _emulate_card(monkeypatch)
    card = IM.int8_linear(x, w, b)
    assert plain.shape == card.shape == (3, 37, 128)
    assert torch.equal(plain, want) and torch.equal(card, want)
    assert IM.LAUNCHES["int8_linear_bf16"] == 1


@pytest.mark.parametrize("route", ["plain", "card"])
def test_kernel_wrappers_refuse_mixed_dtypes(monkeypatch, route):
    """The wrappers never cast behind the caller: f32 x with bf16 weights
    (or the reverse) raises, on the plain route and before any launch on
    the card's; only the layers widen."""
    if route == "card":
        _emulate_card(monkeypatch)
    bad = (TypeError,) if route == "card" else (TypeError, RuntimeError)
    rng = np.random.default_rng(92)
    x = torch.from_numpy(rng.standard_normal((5, 128)).astype(np.float32))
    grid = K.make_bspline_grid(128)
    calls = (
        lambda: IM.int8_linear(x, torch.ones(128, 128, dtype=BF16)),
        lambda: IM.int8_linear(x.to(BF16), torch.ones(128, 128)),
        lambda: FB.bspline_kan(x, grid, torch.ones(4, 128, dtype=BF16),
                               torch.ones(4, 128, 8, dtype=BF16), None),
        lambda: FB.chebykan(x, torch.ones(128, 4, 5, dtype=BF16)),
        lambda: FFN.ffn_pre_ln(x.view(1, 5, 128), *(torch.ones(s, dtype=BF16) for s in (
            (128,), (128,), (16, 128), (16,), (128, 16), (128,)))),
        lambda: FA.flash_attention_lanes(x.view(1, 5, 128), x.view(1, 5, 128).to(BF16),
                                         x.view(1, 5, 128), 2),
    )
    for call in calls:
        with pytest.raises(bad):
            call()
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        IM.int8_linear(x.half(), torch.ones(128, 128, dtype=torch.float16))
    assert not any(n for mod in (FB, FA, FFN, IM) for n in mod.LAUNCHES.values())


# --- kanvit's promotion in the layers -------------------------------------------

def test_promote_widens_only_bf16_parameters_on_f32():
    x32, xbf = torch.zeros(2, 4), torch.zeros(2, 4, dtype=BF16)
    wbf, w32 = torch.full((3,), 1.0 / 3.0).to(BF16), torch.full((3,), 1.0 / 3.0)
    got = precision.promote(x32, wbf, w32, None)
    assert got[0].dtype == torch.float32 and torch.equal(got[0], wbf.float())
    assert got[1] is w32 and got[2] is None
    assert precision.promote(xbf, wbf, w32) == (wbf, w32)
    assert precision.promote(x32.half(), wbf)[0] is wbf


def _layers(gen):
    return {
        "linear": TorchLinear(32, 24, generator=gen),
        "efficientkan": KANLinear(32, 24, generator=gen),
        "cheby": ChebyKANLayer(32, 24, 4, generator=gen),
        "fourier": FourierKANLayer(32, 24, 5, generator=gen),
        "fast": FastKANLayer(32, 24, generator=gen),
        "sine": SineKANLayer(32, 24, 5, generator=gen),
        "layernorm": LayerNorm(32, eps=1e-5),
    }


@pytest.mark.parametrize("kind", ["linear", "efficientkan", "cheby", "fourier", "fast",
                                  "sine", "layernorm"])
def test_bf16_layer_on_f32_x_runs_f32_route(kind):
    """A bf16 layer on f32 activations gives, bit for bit, the f32 layer
    whose parameters hold the same (bf16) values; on bf16 x it stays bf16."""
    layer = _layers(torch.Generator().manual_seed(93))[kind]
    if kind == "layernorm":
        with torch.no_grad():
            layer.weight.normal_(generator=torch.Generator().manual_seed(94))
            layer.bias.normal_(generator=torch.Generator().manual_seed(95))
    bf = precision.cast_params_(copy.deepcopy(layer))
    rounded = copy.deepcopy(bf).float()
    x = torch.from_numpy(np.random.default_rng(96).standard_normal((7, 32))
                         .astype(np.float32))
    with torch.inference_mode():
        got, want = bf(x), rounded(x)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert bf(x.to(BF16)).dtype == BF16


# --- the bf16 models served int8 -------------------------------------------------

@pytest.fixture(scope="module")
def kanvit_runs():
    """kanvit's int8 runs, by ``kanvit_int8``'s arguments: its
    interpret-mode compiles dominate the file's time."""
    return {}


def _images(geom, seed):
    """bf16-valued images: f32 for the port's Predictor, bf16 for kanvit's."""
    x = np.random.default_rng(seed).standard_normal((IMAGES, *geom["chw"]))
    x32 = torch.from_numpy(x.astype(np.float32)).to(BF16).float().numpy()
    return x32, np.asarray(jnp.asarray(x32).astype(jnp.bfloat16))


def _recorder(flow):
    """intercept_methods: the dtype out of the embedder, each block and the
    model, by kanvit's scope path."""
    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        path = "/".join(context.module.scope.path)
        if context.method_name == "__call__" and (
                path in ("", "linear_mapper") or path.count("/") == 0
                and path.startswith("blocks_")):
            flow.append((path or "logits", out.dtype.name))
        return out
    return record


def _port_flow(model, run):
    """The dtype out of the embedder, each block and the model (forward
    hooks) over ``run()``, named as kanvit's scopes."""
    flow, hooks = [], []
    named = [("linear_mapper", model.linear_mapper),
             *((f"blocks_{i}", blk) for i, blk in enumerate(model.blocks)),
             ("logits", model)]
    for name, mod in named:
        hooks.append(mod.register_forward_hook(
            lambda m, a, out, name=name: flow.append((name, str(out.dtype)[6:]))))
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return flow, out


def kanvit_int8(runs, monkeypatch, kind, route, fused=False, calibrate=False):
    """The port's f32 model of ``kind`` (``SMALL``, or ``INT8_GEOM`` on the
    kernel route), and kanvit's int8 ``Predictor`` on its weights rounded to
    bf16: its logits of ``IMAGES`` bf16 images in batches of ``BATCH``, the
    dtype flow of its first (traced) batch, its calibrated scales; kept in
    ``runs``."""
    key = (kind, route, fused, calibrate)
    if key not in runs:
        geom = INT8_GEOM if route == "kernel" else SMALL
        if route == "qdot":
            monkeypatch.setenv("KANVIT_INT8_KERNEL", "0")
        if fused:
            monkeypatch.setenv("KANVIT_FF", "1")
            monkeypatch.setenv("KANVIT_FF_BN", "8")
        port = create_model(kind, **geom, seed=97, fused_ff=fused)
        params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                              _vit_params(port))
        x32, xbf = _images(geom, 98)
        pred = JPredictor(j_create_model(kind, **geom), params, batch_size=BATCH,
                          quant="int8")
        scales = pred.calibrate(xbf) if calibrate else None
        flow = []
        with nn.intercept_methods(_recorder(flow)):
            logits = pred.logits(xbf)
        runs[key] = (port, x32, logits, flow, scales)
    return runs[key]


def _bf16_model(port):
    return precision.cast_params_(copy.deepcopy(port))


def _gates(labels, probs, ref):
    """kanvit's int8 gates (``tests/test_quant.py``) against ``ref``, the
    same bf16 model's float logits."""
    z = ref.astype(np.float64) - ref.max(-1, keepdims=True)
    pf = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    assert (labels == pf.argmax(-1)).mean() >= 0.9
    assert np.abs(probs - pf).max() < 0.2


CASES = [(kind, "qdot") for kind in KINDS] + [(kind, "kernel") for kind in KERNEL_KINDS]


@pytest.mark.parametrize("kind,route", CASES)
def test_dtype_flow_matches_kanvit(kanvit_runs, monkeypatch, kind, route):
    """The embedder's, each block's and the logits' dtype, module for
    module, as kanvit's (its first batch's trace)."""
    port, x32, _, jflow, _ = kanvit_int8(kanvit_runs, monkeypatch, kind, route)
    pred = Predictor(_bf16_model(port), batch_size=BATCH, device="cpu", quant="int8",
                     int8_kernel=route == "kernel")
    flow, _ = _port_flow(pred.model, lambda: pred.logits(x32[:BATCH]))
    assert flow == jflow
    stream = "bfloat16" if route == "kernel" else "float32"
    first_f32 = 0 if kind in ("vanilla", "flash-attn") else 1
    assert [d for name, d in flow if name.startswith("blocks_")][first_f32:] == \
        [stream] * (2 - first_f32)
    assert flow[-1] == ("logits", "float32")


@pytest.mark.parametrize("kind,route", CASES)
def test_int8_bf16_predictor_matches_kanvit(kanvit_runs, monkeypatch, kind, route):
    port, x32, want, _, _ = kanvit_int8(kanvit_runs, monkeypatch, kind, route)
    bf = _bf16_model(port)
    pred = Predictor(bf, batch_size=BATCH, device="cpu", quant="int8",
                     int8_kernel=route == "kernel")
    got = pred.logits(x32)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _maxdiff(got, want) <= LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    float_logits = Predictor(bf, batch_size=BATCH, device="cpu").logits(x32)
    assert not np.array_equal(got, float_logits)
    _gates(*pred.predict(x32), float_logits)


@pytest.mark.parametrize("kind", KERNEL_KINDS)
def test_kernel_route_launches_bf16_int8(kanvit_runs, monkeypatch, kind):
    """The kernel route through the emulated launches: bf16 ``int8_linear``
    for every Linear whose K and out are multiples of 128 (vanilla: the
    embedder and the FF pair a block; efficientkan: the FF pairs; flash-attn:
    the embedder and to_q, to_kv, to_out a block), bf16 attention, no f32
    kernel, and the plain route's logits bit for bit."""
    port, x32, want, _, _ = kanvit_int8(kanvit_runs, monkeypatch, kind, "kernel")
    bf = _bf16_model(port)
    plain = Predictor(bf, batch_size=BATCH, device="cpu", quant="int8",
                      int8_kernel=True).logits(x32)
    _emulate_card(monkeypatch)
    got = Predictor(bf, batch_size=BATCH, device="cpu", quant="int8",
                    int8_kernel=True).logits(x32)
    batches, blocks = -(-IMAGES // BATCH), INT8_GEOM["n_blocks"]
    per_batch = {"vanilla": 1 + 2 * blocks, "efficientkan": 2 * blocks,
                 "flash-attn": 1 + 3 * blocks}[kind]
    counts = {k: n for mod in (FB, FA, FFN, IM) for k, n in mod.LAUNCHES.items() if n}
    want_counts = {"int8_linear_bf16": batches * per_batch,
                   "flash_attention_lanes_bf16": batches * blocks}
    if kind == "efficientkan":
        want_counts.update(bspline_kan_bf16=batches, bspline_qkv_grouped_bf16=batches * blocks)
    assert counts == want_counts
    assert np.array_equal(got, plain)


@pytest.mark.parametrize("kind", ["vanilla", "efficientkan"])
def test_qdot_route_launches_no_int8_kernel(kanvit_runs, monkeypatch, kind):
    """The qdot route through the emulated launches: no ``int8_linear`` of
    either dtype; vanilla's attention in f32 (the stream turned f32 at the
    embedder); efficientkan's embedder and block 0's q/k/v and attention in
    bf16, block 1's in f32 on widened weights (the stream turned f32 at
    block 0's first FF); the plain route's logits within f32 rounding."""
    port, x32, _, _, _ = kanvit_int8(kanvit_runs, monkeypatch, kind, "qdot")
    bf = _bf16_model(port)
    plain = Predictor(bf, batch_size=BATCH, device="cpu", quant="int8").logits(x32)
    _emulate_card(monkeypatch)
    got = Predictor(bf, batch_size=BATCH, device="cpu", quant="int8").logits(x32)
    counts = {k: n for mod in (FB, FA, FFN, IM) for k, n in mod.LAUNCHES.items() if n}
    batches, blocks = -(-IMAGES // BATCH), SMALL["n_blocks"]
    want = {"flash_attention_lanes": batches * blocks}
    if kind == "efficientkan":
        want = {"bspline_kan_bf16": batches, "bspline_qkv_grouped_bf16": batches,
                "flash_attention_lanes_bf16": batches,
                "bspline_qkv_grouped": batches * (blocks - 1),
                "flash_attention_lanes": batches * (blocks - 1)}
    assert counts == want
    assert _maxdiff(got, plain) <= 1e-5 * max(1.0, float(np.abs(plain).max()))


@pytest.mark.parametrize("route", ["qdot", "kernel"])
def test_int8_bf16_calibrated_predictor_matches_kanvit(kanvit_runs, monkeypatch, route):
    """calibrate() on the bf16 model (its bf16 float forward): kanvit's
    layers, maxima within a bf16 forward's rounding of kanvit's; served on
    kanvit's scales, kanvit's calibrated logits; its gates."""
    port, x32, want, _, jscales = kanvit_int8(kanvit_runs, monkeypatch, "vanilla", route,
                                              calibrate=True)
    bf = _bf16_model(port)
    pred = Predictor(bf, batch_size=BATCH, device="cpu", quant="int8",
                     int8_kernel=route == "kernel")
    scales = pred.calibrate(x32)
    mapped = scales_from_jax(jscales)
    blocks = len(port.blocks)
    assert sorted(scales) == sorted(mapped) == sorted(
        ["linear_mapper", "mlp_head.1", *(f"blocks.{i}.ff.{j}" for i in range(blocks)
                                          for j in (0, 2))])
    for name, s in scales.items():
        assert abs(s - mapped[name]) <= SCALE_TOL * mapped[name], name
    assert scales["linear_mapper"] == mapped["linear_mapper"]  # the images' own max
    pred.scales = mapped
    got = pred.logits(x32)
    assert _maxdiff(got, want) <= LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    _gates(*pred.predict(x32), Predictor(bf, batch_size=BATCH, device="cpu").logits(x32))


def test_fused_ff_bf16_int8_qdot_matches_kanvit(kanvit_runs, monkeypatch):
    """The fused-FF vanilla on the qdot route: the embedder's qdot turns the
    stream f32 and the fused FF runs in f32 on widened bf16 weights, as
    kanvit's ``KANVIT_FF=1`` (its ``_dot_dtype`` f32 on f32 x)."""
    port, x32, want, jflow, _ = kanvit_int8(kanvit_runs, monkeypatch, "vanilla", "qdot",
                                            fused=True)
    pred = Predictor(_bf16_model(port), batch_size=BATCH, device="cpu", quant="int8")
    flow, _ = _port_flow(pred.model, lambda: pred.logits(x32[:BATCH]))
    assert flow == jflow and all(d == "float32" for _, d in flow)
    got = pred.logits(x32)
    assert _maxdiff(got, want) <= LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    _emulate_card(monkeypatch)
    card = pred.logits(x32)
    counts = {k: n for mod in (FB, FA, FFN, IM) for k, n in mod.LAUNCHES.items() if n}
    batches = -(-IMAGES // BATCH)
    assert counts == {"ffn_pre_ln": batches * SMALL["n_blocks"],
                      "flash_attention_lanes": batches * SMALL["n_blocks"]}
    assert _maxdiff(card, got) <= 1e-4 * max(1.0, float(np.abs(got).max()))
