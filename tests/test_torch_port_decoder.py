"""The port's CausalDecoder and its LM training step against kanvit's.

kanvit's ``CausalDecoder`` runs under ``set_impl("pallas")`` (Pallas
interpret mode) with params from its own ``init``, carried into the port by
``kanvit_torch.utils.convert``. Both tiers a decoder block can take are
held: at T ≤ 512 with the default buckets the blocks take the lanes kernels;
with 16-wide buckets (kanvit's blocks built through a partial) they take
the tiled ones, as every block does past T = 512. Logits within 1e-4 and
gradients within 1e-5 × max(1, max|g|) of each tensor: f32 through 2 blocks,
sums in another order. Three ``bench_decoder`` LM steps (Adam 1e-3) against
``optax.adam(1e-3)``: losses within 1e-5, parameters within 1e-5 after the
steps (Adam's first step moves each by about lr = 1e-3 whatever its
gradient, so 1e-5 is a hundredth of a step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kanvit.models.decoder as jdecoder
from kanvit.layers.attention import FlashAttentionBlock as JBlock
from kanvit.ops import dispatch as jdispatch
from kanvit_torch import bench_decoder as BD
from kanvit_torch.kernels import flash_attention as FA
from kanvit_torch.models import CausalDecoder
from kanvit_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_port_flash import _emulate_kernels

VOCAB, DIM, HEADS, BLOCKS = 64, 32, 2, 2
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-5
STEP_TOL = 1e-5
TIERS = {"lanes": None, "tiled": (16, 16)}


@pytest.fixture(autouse=True)
def force_pallas():
    jdispatch.set_impl("pallas")
    FA.reset_launches()
    yield
    jdispatch.set_impl("auto")


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _kanvit_decoder(monkeypatch, tier):
    if TIERS[tier] is not None:
        qb, kb = TIERS[tier]
        monkeypatch.setattr(jdecoder, "FlashAttentionBlock", functools.partial(
            JBlock, q_bucket_size=qb, k_bucket_size=kb))
    return jdecoder.CausalDecoder(vocab=VOCAB, dim=DIM, heads=HEADS,
                                  n_blocks=BLOCKS)


def _port_decoder(params, tier):
    model = CausalDecoder(VOCAB, DIM, HEADS, BLOCKS)
    load_reference_state_dict(model, state_dict_from_jax_params(params))
    if TIERS[tier] is not None:
        for blk in model.blocks:
            blk.q_bucket_size, blk.k_bucket_size = TIERS[tier]
    return model


def _tokens(batch, seq, seed=70):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, seq)).astype(np.int32)


def _init(jmodel, tokens):
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(tokens))["params"]
    return jax.tree.map(np.asarray, params)


def _lm_loss_jax(jmodel):
    def loss_fn(p, toks):
        logits = jmodel.apply({"params": p}, toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), toks[:, 1:]).mean()
    return loss_fn


@pytest.mark.parametrize("tier", list(TIERS))
def test_decoder_logits_and_grads_match_kanvit(monkeypatch, tier):
    tokens = _tokens(2, 40)
    jmodel = _kanvit_decoder(monkeypatch, tier)
    params = _init(jmodel, tokens)
    want_logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    want_loss, want_grads = jax.value_and_grad(_lm_loss_jax(jmodel))(
        params, jnp.asarray(tokens))

    model = _port_decoder(params, tier)
    ttok = torch.from_numpy(tokens).long()
    logits = model(ttok)
    assert logits.shape == (2, 40, VOCAB)
    assert _maxdiff(logits.detach(), want_logits) <= LOGIT_TOL
    loss = BD.lm_loss(logits, ttok)
    assert abs(float(loss.detach()) - float(want_loss)) <= LOGIT_TOL
    loss.backward()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads))
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    for name, g in want.items():
        got = grads[name].grad.numpy()
        assert _maxdiff(got, g) <= GRAD_TOL * max(1.0, float(np.abs(g).max())), name


def test_lm_steps_match_optax_adam(monkeypatch):
    """Three ``bench_decoder.make_step`` steps against kanvit's
    ``benchmarks/causal_decoder.py`` step (next-token CE, optax.adam(1e-3)),
    on the tiled tier, the decoder's main path."""
    tokens = _tokens(2, 48, seed=71)
    jmodel = _kanvit_decoder(monkeypatch, "tiled")
    params = _init(jmodel, tokens)
    tx = optax.adam(1e-3)
    loss_fn = _lm_loss_jax(jmodel)

    @jax.jit
    def jstep(p, o, toks):
        loss, grads = jax.value_and_grad(loss_fn)(p, toks)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    model = _port_decoder(params, "tiled")
    step = BD.make_step(model, "kernel")
    ttok = torch.from_numpy(tokens).long()
    p, o = params, tx.init(params)
    for _ in range(3):
        p, o, want = jstep(p, o, jnp.asarray(tokens))
        got = step(ttok)
        assert abs(float(got) - float(want)) <= STEP_TOL
    want_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, p))
    for name, t in model.state_dict().items():
        assert _maxdiff(t, want_sd[name]) <= STEP_TOL, name


def test_decoder_steps_take_the_tiled_kernels(monkeypatch):
    """Past one tile every block launches the tiled forward, dq and dk/dv
    kernels once a step, and no lanes kernel (here with 16-wide buckets, as
    at T > 512 with the default ones)."""
    _emulate_kernels(monkeypatch)
    model = BD.build_model(DIM, HEADS, BLOCKS, VOCAB, seed=4)
    for blk in model.blocks:
        blk.q_bucket_size = blk.k_bucket_size = 16
    step = BD.make_step(model)
    tokens = BD.make_tokens(2, 40, VOCAB)
    losses = []
    for _ in range(2):
        FA.reset_launches()
        losses.append(float(step(tokens)))
        assert {k: n for k, n in FA.LAUNCHES.items() if n} == {
            "flash_attention": BLOCKS, "flash_attention_dq": BLOCKS,
            "flash_attention_dkv": BLOCKS}
    assert np.isfinite(losses).all() and losses[1] < losses[0]


def test_plain_impl_matches_the_model():
    """``impl="plain"`` runs the same weights through
    ``flash_attention_reference``: the same logits at T = 600 (tiled tier,
    the model's own plain version on the CPU) and at T = 40, where the
    model takes the lanes tier (no mask, so the tiers agree)."""
    model = BD.build_model(DIM, HEADS, BLOCKS, VOCAB, seed=5)
    for seq in (40, 600):
        tokens = BD.make_tokens(1, seq, VOCAB)
        with torch.inference_mode():
            assert _maxdiff(BD.plain_logits(model, tokens), model(tokens)) <= 1e-5


def test_bench_decoder_cli(capsys):
    results = BD.main(["--device", "cpu", "--seqs", "16", "40", "--dim", "32",
                       "--heads", "2", "--n-blocks", "1", "--vocab", "32",
                       "--steps", "2", "--warmup", "1", "--tokens-per-batch", "80"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(results) == 4
    assert [(r["seq"], r["batch"], r["impl"]) for r in results] == [
        (16, 5, "kernel"), (16, 5, "plain"), (40, 2, "kernel"), (40, 2, "plain")]
    for r in results:
        assert {"seq", "batch", "impl", "step_ms", "tokens_per_sec", "loss"} <= set(r)
        assert r["step_ms"] > 0 and np.isfinite(r["loss"])
    assert abs(results[0]["loss"] - results[1]["loss"]) <= 1e-5
    only = BD.main(["--device", "cpu", "--seqs", "16", "--dim", "32", "--heads", "2",
                    "--n-blocks", "1", "--vocab", "32", "--steps", "1",
                    "--warmup", "0", "--skip-naive"])
    assert [r["impl"] for r in only] == ["kernel"]


@pytest.mark.parametrize("flag", [["--bf16"], ["--ring", "4"]])
def test_bench_decoder_refuses_unported(flag):
    with pytest.raises(NotImplementedError):
        BD.main(["--device", "cpu", "--seqs", "16", *flag])


def test_decoder_refuses_ring_attention():
    with pytest.raises(NotImplementedError, match="ring attention"):
        CausalDecoder(VOCAB, DIM, HEADS, BLOCKS, seq_axis="data")


def test_decoder_state_dict_names(monkeypatch):
    """kanvit's decoder tree converts to exactly the port's parameters."""
    params = _init(_kanvit_decoder(monkeypatch, "lanes"), _tokens(1, 8))
    sd = state_dict_from_jax_params(params)
    port = CausalDecoder(VOCAB, DIM, HEADS, BLOCKS).state_dict()
    assert set(sd) == set(port)
    for k, v in port.items():
        assert tuple(v.shape) == sd[k].shape, k
    assert "embed.weight" in sd and "lm_head.bias" in sd and "norm.weight" in sd


def test_embedding_init_matches_flax():
    """Normal with std dim ** -0.5, as flax ``nn.Embed``'s default
    (distributions only: the two draw from different generators)."""
    import flax.linen as nn

    vocab, dim = 1024, 256
    j = np.asarray(nn.Embed(vocab, dim).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 2), jnp.int32))["params"]["embedding"])
    t = CausalDecoder(vocab, dim, 2, 1, generator=torch.Generator().manual_seed(5)
                      ).embed.weight.detach().numpy()
    for w in (j, t):
        assert w.shape == (vocab, dim)
        assert abs(w.std() / dim ** -0.5 - 1.0) < 0.02
        assert abs(w.mean()) < 0.01 * dim ** -0.5 * 10
        assert np.abs(w).max() > 3.5 * dim ** -0.5  # not truncated at 2 std
