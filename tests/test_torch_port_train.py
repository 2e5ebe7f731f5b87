"""The port's training step against kanvit's: optimizer, step and bench.

- ``make_optimizer`` against kanvit's optax chain on a small param dict,
  fed the same numpy gradients for 5 steps.
- The train step: kanvit's ``make_train_step`` (its Pallas kernels in
  interpret mode) against the port's over K = 3 steps on fixed batches, on
  the same weights carried across by ``state_dict_from_jax_params``
  (``run_steps`` and its checks, shared with the other variants' files).
- ``grad_accum``, the bench entry point and its FLOP count.

f32 on the CPU. Inputs come from numpy seeds.
"""

import json
import math
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as jax_bench
from kanvit.models import create_model as j_create_model
from kanvit.ops import dispatch as jdispatch
from kanvit.train.state import create_train_state as j_create_train_state
from kanvit.train.state import ema_params as j_ema_params
from kanvit.train.state import make_optimizer as j_make_optimizer
from kanvit.train.steps import make_train_step as j_make_train_step
from kanvit_torch import VARIANTS
from kanvit_torch import bench as port_bench
from kanvit_torch.models import PRESETS, create_model
from kanvit_torch.train import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)

REPO = __file__.rsplit("/tests/", 1)[0]
SMALL = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
             out_d=10)
LR = 1e-3
GRAD_TOL = 1e-5   # x max(1, max|g|) per tensor, step 1
K_STEPS = 3


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# --- make_optimizer against optax --------------------------------------------

OPT_CASES = {
    "adam": dict(),
    "adamw": dict(weight_decay=0.1),
    "warmup": dict(warmup_steps=3),
    "warmup_cosine": dict(lr_schedule="cosine", warmup_steps=2, total_steps=5),
    "cosine": dict(lr_schedule="cosine", total_steps=4),
    "clip": dict(clip_grad_norm=4.0),
    "ema": dict(ema_decay=0.9),
    "all": dict(lr_schedule="cosine", warmup_steps=1, total_steps=6,
                weight_decay=0.05, clip_grad_norm=4.0, ema_decay=0.5),
}
# Per-step gradient scales: the global norm of the unscaled gradients is
# ~5.6, so under clip 4.0 steps 0, 2 and 4 are clipped and 1 and 3 are not.
GRAD_SCALES = (1.0, 0.3, 2.0, 0.5, 1.5)


def _opt_problem():
    rng = np.random.default_rng(30)
    shapes = {"w": (4, 3), "b": (3,), "s": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32)
              for k, s in shapes.items()} for sc in GRAD_SCALES]
    return params, grads


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_make_optimizer_matches_optax(case):
    """5 steps on the same gradients: params (and the EMA) within 1e-6.
    Both sides see identical gradients, so only the update's rounding
    differs (Adam's step is ~lr = 1e-3 per element)."""
    kw = OPT_CASES[case]
    params, grads = _opt_problem()
    tx = j_make_optimizer(LR, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    chain = make_optimizer(tp, LR, **kw)
    norms = []
    for g in grads:
        norms.append(math.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2))
                                   for a in g.values())))
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        chain.step()
    for k in params:
        assert _maxdiff(tp[k].detach(), jp[k]) <= 1e-6, k
    if "clip_grad_norm" in kw:
        assert min(norms) < kw["clip_grad_norm"] < max(norms)
    if "ema_decay" in kw:
        jema = j_ema_params(type("S", (), {"opt_state": state})())
        for k in params:
            assert _maxdiff(chain.ema[k], jema[k]) <= 1e-6, k
    else:
        assert chain.ema is None


def test_make_optimizer_guards():
    p = {"w": torch.zeros(2, requires_grad=True)}
    with pytest.raises(ValueError, match="must be < the total step"):
        make_optimizer(p, lr_schedule="cosine", warmup_steps=5, total_steps=5)
    with pytest.raises(ValueError, match="needs a known total step"):
        make_optimizer(p, lr_schedule="cosine")
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        make_optimizer(p, lr_schedule="linear")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 2 item 5"):
        make_train_step(bf16=True)


def test_clip_differs_from_torch_clip_grad_norm():
    """The chain clips with optax's ``g / ||g|| * c``; torch's
    ``clip_grad_norm_`` would give ``g * c / (||g|| + 1e-6)``."""
    from kanvit_torch.train.state import clip_by_global_norm_

    g = torch.tensor([3.0, 4.0])  # norm 5
    ours = g.clone()
    clip_by_global_norm_([ours], 1.0)
    assert torch.equal(ours, g / 5.0 * 1.0)
    theirs = torch.nn.Parameter(torch.zeros(2))
    theirs.grad = g.clone()
    torch.nn.utils.clip_grad_norm_([theirs], 1.0)
    assert not torch.equal(theirs.grad, ours)
    below = torch.tensor([0.3, 0.4])
    clip_by_global_norm_([below], 1.0)
    assert torch.equal(below, torch.tensor([0.3, 0.4]))


# --- the train step against kanvit's ------------------------------------------

def _adam_state(opt_state):
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    found = [_adam_state(o) for o in opt_state if isinstance(o, tuple)]
    return next(f for f in found if f is not None) if found else None


def run_steps(variant, geometry, seed=31, steps=K_STEPS):
    """``steps`` train steps of kanvit (Pallas kernels in interpret mode)
    and of the port, from the same weights on the same fixed batches.
    Returns the losses of both, the step-1 gradients and the final params,
    kanvit's carried across by ``state_dict_from_jax_params``."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((steps, 8, *geometry["chw"])).astype(np.float32)
    ys = rng.integers(0, geometry["out_d"], (steps, 8))

    jmodel = j_create_model(variant, **geometry)
    jdispatch.set_impl("jnp")  # init is plain jnp; only the weights matter
    try:
        state = j_create_train_state(jmodel, jax.random.PRNGKey(4),
                                     jnp.zeros((1, *geometry["chw"])))
    finally:
        jdispatch.set_impl("pallas")
    try:
        params0 = jax.tree.map(np.asarray, state.params)
        step = j_make_train_step(donate=False)
        jlosses, jgrads = [], None
        for x, y in zip(xs, ys):
            state, loss, _ = step(state, jnp.asarray(x), jnp.asarray(y))
            jlosses.append(float(loss))
            if jgrads is None:
                # After one update Adam's first moment is (1 - b1) * g: the
                # step-1 gradients without compiling a second program.
                jgrads = jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                      _adam_state(state.opt_state).mu)
        jparams = jax.tree.map(np.asarray, state.params)
    finally:
        jdispatch.set_impl("auto")

    model = create_model(variant, **geometry, seed=9)
    load_reference_state_dict(model, state_dict_from_jax_params(params0))
    tstate = create_train_state(model, LR)
    tstep = make_train_step()
    tlosses, tgrads = [], None
    for x, y in zip(xs, ys):
        tstate, loss, logits = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        assert isinstance(loss, torch.Tensor) and isinstance(logits, torch.Tensor)
        tlosses.append(float(loss))
        if tgrads is None:
            tgrads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return dict(jlosses=jlosses, tlosses=tlosses,
                jgrads=state_dict_from_jax_params(jgrads),
                tgrads=tgrads, jparams=state_dict_from_jax_params(jparams),
                tparams={k: p.detach() for k, p in model.named_parameters()})


def check_losses(run):
    """Per-step CE loss: f32 logits agree to ~1e-6, so the losses to 1e-5."""
    assert len(run["tlosses"]) == len(run["jlosses"]) > 0
    for got, want in zip(run["tlosses"], run["jlosses"]):
        assert abs(got - want) <= 1e-5


def check_grads(run):
    """Step-1 gradients per tensor within 1e-5 x max(1, max|g|); the JAX
    grads carried across by the same converter as the weights."""
    jg, tg = run["jgrads"], run["tgrads"]
    assert set(jg) == set(tg)
    for k in jg:
        assert tg[k].shape == jg[k].shape, k
        assert bool(tg[k].isfinite().all()), k
        assert _maxdiff(tg[k], jg[k]) <= GRAD_TOL * max(1.0, float(np.abs(jg[k]).max())), k


def _zero_in_exact_arithmetic(name, shape):
    """The constant term of each key projection: it adds the same q . b to
    every score of a query's row, which the softmax cancels, so its
    gradient is 0 in exact arithmetic and f32 rounding noise in both
    frameworks (a Linear, FastKAN or SineKAN key's bias, a ChebyKAN key's
    T_0 = 1 slice; not a FastKAN key's LayerNorm bias)."""
    mask = np.zeros(shape, bool)
    if re.search(r"\.k_mappings\.\d+\.(base_linear\.)?bias$", name):
        mask[...] = True
    elif ".k_mappings." in name and name.endswith(".cheby_coeffs"):
        mask[..., 0] = True
    return mask


def check_params(run, steps=K_STEPS, g_floor=0.0, min_resolved=0.99):
    """Params after ``steps`` Adam steps.

    Adam normalises each element's step to about lr = 1e-3 whatever the
    gradient's size (the first step is lr * g / (|g| + 1e-8)). Where a
    gradient element is near rounding level the two frameworks may give it
    a different sign, and that element then moves by up to 2 lr per step in
    opposite directions; nothing else can move it that far. So every element
    is held within 2 * K * lr. The elements whose step-1 gradient is above
    1e-6 x its tensor's max (an order above f32 rounding of a sum of this
    depth, ~1e-7 relative), or exactly 0 in both (spline coefficients of
    bases no input reaches: Adam leaves them in place), are held within
    1e-5, 1% of one step; they are at least ``min_resolved`` (99%) of all
    elements whose gradient is not 0 in exact arithmetic
    (``_zero_in_exact_arithmetic``). ``g_floor`` also leaves out elements
    whose step-1 gradient is below it: where |g| is near Adam's eps (1e-8)
    the first update lr g / (|g| + eps) carries the gradient's relative
    rounding error over in full.
    """
    jp, tp = run["jparams"], run["tparams"]
    jg, tg = run["jgrads"], run["tgrads"]
    resolved = total = 0
    for k in jp:
        diff = np.abs(tp[k].numpy().astype(np.float64) - jp[k])
        assert diff.max() <= 2 * steps * LR, k
        g = np.abs(jg[k])
        live = ~_zero_in_exact_arithmetic(k, g.shape)
        held = live & (((g > 1e-6 * g[live].max(initial=0.0)) & (g >= g_floor))
                       | ((g == 0) & (tg[k].numpy() == 0)))
        resolved += int(held.sum())
        total += int(live.sum())
        if held.any():
            assert diff[held].max() <= 1e-5, k
    assert resolved >= min_resolved * total


@pytest.fixture(scope="module")
def step_run():
    return run_steps("efficientkan", SMALL)


def test_train_step_losses_match_kanvit(step_run):
    check_losses(step_run)


def test_train_step_grads_match_kanvit(step_run):
    check_grads(step_run)


def test_train_step_params_match_kanvit(step_run):
    check_params(step_run)


def test_grad_accum_matches_one_batch():
    """2 chunks: the same loss, the same averaged gradients, the same
    update as one batch of 8."""
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((8, *SMALL["chw"])).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, SMALL["out_d"], 8))
    runs = []
    for accum in (1, 2):
        model = create_model("efficientkan", **SMALL, seed=10)
        state, loss, logits = make_train_step(grad_accum=accum)(
            create_train_state(model), x, y)
        runs.append((float(loss), logits, dict(model.named_parameters())))
    (l1, o1, p1), (l2, o2, p2) = runs
    assert abs(l1 - l2) <= 1e-6
    assert _maxdiff(o1, o2) <= 1e-5
    for k in p1:
        g1, g2 = p1[k].grad, p2[k].grad
        assert _maxdiff(g1, g2) <= 1e-6 * max(1.0, float(g1.abs().max())), k
        assert _maxdiff(p1[k].detach(), p2[k].detach()) <= 2 * LR, k
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(grad_accum=3)(create_train_state(
            create_model("efficientkan", **SMALL)), x, y)


def test_eval_step():
    model = create_model("efficientkan", **SMALL, seed=11)
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((5, *SMALL["chw"])).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, SMALL["out_d"], 5))
    state = create_train_state(model)
    loss, logits = make_eval_step()(state, x, y)
    per, _ = make_eval_step(per_example=True)(state, x, y)
    assert loss.shape == () and per.shape == (5,) and logits.shape == (5, 10)
    assert abs(float(per.mean()) - float(loss)) <= 1e-6


# --- the bench entry point ----------------------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "step_time_ms",
              "step_time_ms_minmax", "windows", "steps_per_call", "batch_size",
              "grad_accum", "device", "bf16", "flops_per_step", "mfu",
              "flops_per_step_xla", "mfu_xla", "peak_flops_bf16"}


def test_bench_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "kanvit_torch.bench", "--device", "cpu",
         "--preset", "reference", "--steps", "2", "--windows", "1",
         "--warmup", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "mnist_efficientkan_train_images_per_sec_per_chip"
    assert out["value"] > 0 and out["steps_per_call"] == 1
    assert out["batch_size"] == 128 and out["device"] == "cpu"
    assert out["flops_per_step_xla"] is None and out["mfu_xla"] is None
    assert out["flops_per_step"] == jax_bench._analytic_flops(
        "efficientkan", jax_bench.PRESETS["reference"], 128)


def test_bench_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        port_bench.run(port_bench.parse_args(["--steps", "1"]))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_analytic_flops_is_benchs(preset):
    assert PRESETS[preset] == jax_bench.PRESETS[preset]
    for variant in VARIANTS:
        for batch in (1, 64, 128):
            assert port_bench._analytic_flops(variant, PRESETS[preset], batch) == \
                jax_bench._analytic_flops(variant, jax_bench.PRESETS[preset], batch)


def test_peak_flops_by_card_name(monkeypatch):
    cuda = torch.device("cuda")
    for name, want in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert port_bench.peak_flops_bf16(cuda) == want
    assert port_bench.peak_flops_bf16(torch.device("cpu")) is None
