"""The port's Predictor against ``kanvit.infer.Predictor`` on the same weights.

Fixed-size batches with a zero-padded ragged tail, ``microbatch`` chunks,
``predict`` and ``load_predictor`` from a reference-named ``.npz``. f32 on
the CPU; logits must agree to 1e-3 (observed ~1e-6).
"""

import numpy as np
import pytest
import torch

from kanvit.infer import Predictor as JPredictor
from kanvit.models import create_model as j_create_model
from kanvit.utils.torch_compat import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from kanvit_torch.infer import Predictor, load_predictor
from kanvit_torch.models import create_model

LOGIT_TOL = 1e-3
GEOM = dict(chw=(1, 28, 28), n_patches=7, n_blocks=2, d_hidden=32, n_heads=2,
            out_d=10)


@pytest.fixture(scope="module")
def served():
    model = create_model("efficientkan", **GEOM, seed=7)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    images = np.random.default_rng(30).standard_normal((7, 1, 28, 28)).astype(np.float32)
    return model, params_from_torch_state_dict(sd), images


@pytest.mark.parametrize("batch_size,microbatch", [(4, None), (4, 2), (8, None)])
def test_logits_match_kanvit_predictor(served, batch_size, microbatch):
    model, params, images = served
    jpred = JPredictor(j_create_model("efficientkan", **GEOM), params,
                       batch_size, microbatch)
    pred = Predictor(model, batch_size, microbatch, device="cpu")
    got, want = pred.logits(images), jpred.logits(images)
    assert got.shape == want.shape == (7, 10) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= LOGIT_TOL


def test_predict_matches_kanvit(served):
    model, params, images = served
    jlabels, jprobs = JPredictor(j_create_model("efficientkan", **GEOM), params,
                                 4).predict(images)
    labels, probs = Predictor(model, 4, device="cpu").predict(images)
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-12)
    assert float(np.abs(probs - jprobs).max()) <= 1e-5
    assert np.array_equal(labels, jlabels)


@pytest.mark.parametrize("microbatch,want", [(None, [4, 4]), (2, [2, 2, 2, 2])])
def test_fixed_size_batches(served, microbatch, want):
    """Every forward sees a full batch (or equal microbatch chunks): the
    ragged tail of 3 images is zero-padded, never run at its own size."""
    model, _, images = served
    seen = []
    handle = model.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape[0]))
    try:
        y = Predictor(model, 4, microbatch, device="cpu").logits(images)
    finally:
        handle.remove()
    assert seen == want
    assert y.shape == (7, 10)
    with torch.inference_mode():
        alone = model(torch.from_numpy(images[4:])).numpy()
    assert float(np.abs(y[4:] - alone).max()) <= 1e-5  # padding does not leak


def test_empty_request(served):
    model, _, _ = served
    out = Predictor(model, 4, device="cpu").logits(np.zeros((0, 1, 28, 28), np.float32))
    assert out.shape == (0,)


def test_predictor_checks_device(served):
    model, _, _ = served
    with pytest.raises(ValueError, match=r"call model.to\(device\) first"):
        Predictor(model, 4, device="meta")


def test_load_predictor_from_npz(served, tmp_path):
    """The .npz that ``python -m kanvit.utils.torch_compat`` writes loads
    straight into the port's Predictor."""
    model, params, images = served
    path = tmp_path / "sd.npz"
    np.savez(path, **torch_state_dict_from_params(params))
    pred = load_predictor("efficientkan", str(path), device="cpu", batch_size=4,
                          n_blocks=2, d_hidden=32, n_heads=2)
    want = Predictor(model, 4, device="cpu").logits(images)
    assert np.array_equal(pred.logits(images), want)
