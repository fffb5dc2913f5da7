"""Training LayoutDM and VQDiffusion in the port against the JAX package,
on the CPU: preprocess, the diffusion loss and its terms given JAX's
uniforms (both `q_type`s: LayoutDM's `constrained`, VQDiffusion's
`default`), the timesteps' importance sampling bit for bit, a three-step
`Trainer.fit` against JAX's, and `cli.train --debug` whose checkpoint both
packages' `cli.inference` read.  The checks, models and tolerances are
`test_torch_port_zoo_train.py`'s.
"""

import numpy as np
import pytest
import torch
from test_torch_port_zoo_train import (  # noqa: F401  (fixtures)
    BATCH,
    cache_dir,
    check_cli,
    check_fit,
    check_loss,
    check_preprocess,
    jax_draws,
    job_root,
    pair,
)

torch.set_num_threads(2)
PRESETS = ("layoutdm", "vqdiffusion")


@pytest.fixture(scope="module")
def layoutdm(cache_dir):
    return pair("layoutdm", cache_dir)


@pytest.mark.parametrize("preset", PRESETS)
def test_preprocess_matches_jax(cache_dir, preset):
    check_preprocess(pair(preset, cache_dir))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_loss_and_terms_match_jax_given_its_uniforms(cache_dir, jax_draws, preset, train):
    check_loss(pair(preset, cache_dir), train)


def test_sample_time_and_update_importance_are_bit_for_bit(layoutdm):
    """Uniform timesteps until every t is seen more than 10 times, then the
    importance branch: both generators' statistics and draws equal bit for
    bit over 40 batches of 8."""
    jg, _, tg, _, _ = layoutdm
    saved = [(g.Lt_history.copy(), g.Lt_count.copy()) for g in (jg, tg)]
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    kl_rng = np.random.default_rng(1)
    branches = set()
    try:
        for _ in range(40):
            branches.add(bool((tg.Lt_count > 10).all()))
            (jt, jp), (tt, tp) = jg.sample_time(BATCH, jr), tg.sample_time(BATCH, tr)
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_array_equal(tp, jp)
            kl = kl_rng.gamma(2.0, 1.0, BATCH).astype(np.float32)
            jg.update_importance(jt, kl)
            tg.update_importance(tt, kl)
            np.testing.assert_array_equal(tg.Lt_history, jg.Lt_history)
            np.testing.assert_array_equal(tg.Lt_count, jg.Lt_count)
    finally:
        for g, (h, c) in zip((jg, tg), saved):
            g.Lt_history, g.Lt_count = h, c
    assert branches == {False, True}



@pytest.mark.parametrize("preset", PRESETS)
def test_three_step_fit_matches_jax(cache_dir, jax_draws, job_root, preset):
    check_fit(preset, pair(preset, cache_dir), job_root)


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_train_checkpoint_reads_in_both_cli_inferences(cache_dir, job_root, preset):
    check_cli(preset, cache_dir, job_root)
