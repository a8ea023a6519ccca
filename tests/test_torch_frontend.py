"""The vlm/audio frontend embeddings (models/decoder.py::embed_tokens)
against the JAX package's, on the CPU at the reduced sizes, in f32, from
the reference's parameters (converted with ``convert.lm_params``).

Configs: the reduced musicgen-medium (audio) and internvl2-76b (vlm),
each with 8 frontend positions ([B, 8, d] embeddings from a numpy seed).

* forward (logits), prefill (last logits and every cache tensor) with the
  embeddings, and 4 decode steps from the reference's prefill caches:
  test_torch_lm.py's tests and tolerance (1e-4 of the reference's largest
  magnitude) on this module's ``lm`` fixture.
* The loss with the embeddings (their positions carry no loss) and its
  flat gradient: test_torch_lm_train.py's check (loss within rel 1e-5, the
  gradient within 1e-4 of the reference's largest magnitude).
* The loss's frontend mask equals an explicit loss mask over the same
  targets, to the last bit, and the embeddings reach the logits.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models.decoder import build_model

import test_torch_lm
import test_torch_lm_train
from test_torch_lm import (test_decode_steps_match_reference,  # noqa: F401
                           test_forward_matches_reference,
                           test_prefill_matches_reference)
from torch_threads import one_torch_thread  # noqa: F401

FRONTEND_CONFIGS = {"musicgen-medium": ("musicgen-medium", None),
                    "internvl2-76b": ("internvl2-76b", None)}


@pytest.fixture(scope="module", params=list(FRONTEND_CONFIGS))
def lm(request):
    """test_torch_lm.py's reference results, with frontend embeddings."""
    return test_torch_lm.reference_results(request.param, FRONTEND_CONFIGS)


def test_reduced_configs_keep_a_frontend():
    for arch in FRONTEND_CONFIGS:
        cfg = get_arch(arch).reduced()
        assert cfg.family in ("vlm", "audio") and cfg.frontend_tokens == 8


@pytest.mark.parametrize("arch", list(FRONTEND_CONFIGS))
def test_loss_and_gradient_match_reference(arch):
    test_torch_lm_train.check_loss_and_gradient(arch, arch, None, 128)


@pytest.mark.parametrize("arch", list(FRONTEND_CONFIGS))
@torch.inference_mode()
def test_frontend_positions_carry_no_loss(arch):
    """loss(tokens, mask, embeds) is the loss with the targets of positions
    [0, P) masked out explicitly (loss_mask[:, 1:P+1] = 0), bit for bit;
    the embeddings change the logits of every position."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(4)
    Bn, S, P = 2, 32, cfg.frontend_tokens
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bn, S)).astype(np.int32))
    embeds = torch.from_numpy(rng.standard_normal((Bn, P, cfg.d_model)).astype(np.float32))
    mask = torch.from_numpy((rng.random((Bn, S)) < 0.8).astype(np.float32))
    explicit = mask.clone()
    explicit[:, 1:P + 1] = 0
    got = model.loss(tokens, mask, embeds)
    want = model.loss(tokens, explicit, embeds)
    assert torch.equal(got, want), (float(got), float(want))
    assert float(model.loss(tokens, mask)) != float(got)
    with_e, _ = model(tokens, embeds)
    without, _ = model(tokens)
    assert bool((with_e - without).abs().amax(-1).gt(0).all())
