"""Training RA-LayoutDM in the port against the JAX package, on the CPU:
preprocess with the retrieved layouts, the loss and its terms given JAX's
uniforms, a three-step `Trainer.fit` against JAX's in which the frozen
FIDNet (K1's plain version in every train step, under no_grad) moves on
neither side, and `cli.train --debug` whose checkpoint both packages'
`cli.inference` read.  The checks, models and tolerances are
`test_torch_port_zoo_train.py`'s.
"""

import numpy as np
import pytest
import torch
from test_torch_port_zoo_train import (  # noqa: F401  (fixtures)
    cache_dir,
    check_cli,
    check_fit,
    check_loss,
    check_preprocess,
    first_batches,
    jax_draws,
    job_root,
    pair,
)

from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ra(cache_dir):
    return pair("layoutdm_ra", cache_dir)


def test_preprocess_matches_jax(ra):
    check_preprocess(ra)


@pytest.mark.parametrize("train", [False, True])
def test_loss_and_terms_match_jax_given_its_uniforms(ra, jax_draws, train):
    check_loss(ra, train)


def test_three_step_fit_matches_jax(ra, jax_draws, job_root):
    check_fit("layoutdm_ra", ra, job_root)


def test_cli_train_checkpoint_reads_in_both_cli_inferences(cache_dir, job_root):
    check_cli("layoutdm_ra", cache_dir, job_root, cond="uncond")


def test_k1_runs_only_in_the_frozen_fidnet_of_a_train_step(ra, job_root, monkeypatch):
    """A train step calls K1's wrapper 4 times (FIDNet's layers, in eval mode
    under no_grad) and no gradient reaches FIDNet; an eval step adds the
    image encoder's and the denoising decoder's self-attention (1 + 1)."""
    _, v, tg, _, _ = ra
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    calls = []
    launch = tnn.encoder_attention
    monkeypatch.setattr(tnn, "encoder_attention", lambda *a: calls.append(1) or launch(*a))
    trainer = Trainer(tg, TrainConfig(job_dir=str(job_root)))
    state = trainer.init_state()
    inputs, targets = tg.preprocess(first_batches(ra)[1], np.random.default_rng(0))
    trainer.train_step(state, inputs, targets)
    fidnet = tg.core.retrieval_aug.layout_encoder
    assert len(calls) == 4 and tg.core.training and not fidnet.training
    assert all(p.grad is None and p.requires_grad for p in fidnet.parameters())
    trainer.eval_step(state, inputs, targets)
    assert len(calls) == 4 + 4 + 1 + 1
