"""The training cell end to end on the CPU at a tiny size (the look for a
card skipped): a sound run comes out correct and reports its metrics, and a
run with each fault that a one-card training cell can have planted in the
timed path comes out not correct (a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest), as does the
reference in TF32 put in the program's place.  The reference's grouping of
the parameters is the program's optimizer's."""

from __future__ import annotations

import sys
import time

import pytest
import torch

from benchmark import run as brun
from benchmark.lib import manifest
from benchmark.loops import train
from benchmark.tests.tiny import tiny_cell

sys.path.insert(0, str(manifest.BENCH_DIR / "controls"))
import train as train_controls  # noqa: E402

ROOT = manifest.BENCH_DIR.parent
CELL = "ralf-cgl.train-b32"
SEED = 2**31 + 7


def cell():
    c = tiny_cell("ralf-cgl", "train-b32", canvases=8, batch=8)
    real = manifest.Manifest(ROOT).cell(CELL)
    c.end_to_end, c.per_layer = real.end_to_end, real.per_layer
    return c


def test_sound_train_run_is_correct_and_reports_its_metrics():
    res = brun.execute(torch, cell(), SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert res["attempted"] >= 1 and res["info"]["leaves_changed_compared"] > 100


def test_traced_train_run_reports_its_layers():
    res = brun.execute(torch, cell(), SEED, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    assert {"loader_wait_ms", "optimizer_ms", "mfu.train"} <= set(res["metrics"])
    assert 0 < res["metrics"]["mfu.train"]["value"] < 100


@pytest.mark.parametrize("way", ["half_batch", "unchanged"])
def test_a_fault_in_the_train_step_is_not_correct(way):
    out = train_controls.reading(torch, cell(), SEED, way, torch.device("cpu"))
    assert not out["correct"], out
    if way == "unchanged":  # reads 1 on the gradient and the change
        assert out["checks"]["grad_gap"][0] == pytest.approx(1.0)
        assert out["checks"]["change_gap"][0] == pytest.approx(1.0)


def test_the_reference_in_tf32_in_the_programs_place_is_not_correct():
    c = cell()
    fam = train.family(c.config)
    prog = fam.build(torch, c.config, c.traffic, SEED, torch.device("cpu"))
    rows, _, masks = train.checked(torch, fam, prog, c.traffic, train.Spans())
    fam.release(torch, prog)
    low = fam.reference(torch, prog, rows, masks, "tf32")
    _, checks = fam.compare(low, fam.reference(torch, prog, rows, masks),
                            c.config["train"]["limits"])
    assert not brun.is_correct(checks), checks


def test_reference_groups_the_parameters_as_the_programs_optimizer():
    from benchmark.references import ralf_train as ref
    from ralf_tpu_torch.train.optim import decay_mask, lr_group_labels

    c = cell()
    prog = train.family(c.config).build(torch, c.config, c.traffic, SEED, torch.device("cpu"))
    core = prog.state.module
    labels, decay = lr_group_labels(core), decay_mask(core)
    names = set(ref.trainable(prog.weights))
    assert names == {n for n, lab in labels.items() if lab != "frozen"}
    for n, p in core.named_parameters():
        if n in names:
            assert ref.decayed(n, p) == decay[n], n
            assert n.startswith(ref.TRUNK) == (labels[n] == "trunk"), n


def test_reference_tokens_are_the_programs_feed():
    import numpy as np

    from benchmark.references import ralf as ref
    from benchmark.references import ralf_train

    c = cell()
    prog = train.family(c.config).build(torch, c.config, c.traffic, SEED, torch.device("cpu"))
    batch = next(prog.batches)
    inputs, targets = prog.gen.preprocess(batch, np.random.default_rng(0))
    v = ref.Vocab(c.config["dataset"]["num_labels"], c.config["tokenizer"]["num_bin"],
                  c.config["dataset"]["max_seq_length"])
    want = ralf_train.step_inputs(c.config, prog.split, prog.canvases, prog.table,
                                  np.asarray(batch["indices"]), v)
    np.testing.assert_array_equal(inputs["seq"].numpy(), want["tokens"][:, :-1])
    np.testing.assert_array_equal(targets["seq"].numpy(), want["tokens"][:, 1:])
    np.testing.assert_array_equal(inputs["tgt_keep"].numpy(), want["tokens"][:, :-1] != v.pad)
    np.testing.assert_array_equal(inputs["image"].cpu().numpy(), want["image"])
    for k, a in want["retrieved"].items():
        np.testing.assert_array_equal(np.asarray(inputs["retrieved"][k].cpu()), a)
