"""The port's spans and counters (`ralf_tpu_torch/utils/tracing.py`) on the
CPU: off, a span is one shared no-op that reads no clock and opens no
`record_function`; a torch profiler turns the spans on by itself; a tiny
RALF request, a tiny LayoutDM request and a tiny RALF `Trainer.fit` give
the spans their layers promise, nested by parent id; every record lies on
Kineto's clock beside its user annotation; the host-to-device byte counters
count what is handed over; and tokens, layouts and losses are bit for bit
the same with tracing on and off.  No JAX: the generators are random from
their seeds, the data the port's synthetic posters."""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ralf_tpu_torch.core.conditioning import build_forced_tokens
from ralf_tpu_torch.core.sampling import SamplingConfig
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
from ralf_tpu_torch.eval.violations import calculate_violation
from ralf_tpu_torch.models.base import GeneratorConfig
from ralf_tpu_torch.models.diffusion import LayoutDMGenerator
from ralf_tpu_torch.models.ralf import RETRIEVED_KEYS, RALFGenerator
from ralf_tpu_torch.retrieval.retriever import Retriever
from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
from ralf_tpu_torch.utils import tracing
from ralf_tpu_torch.utils.weights import export_params

torch.set_num_threads(2)
S, HW, K, B, N = 10, (64, 48), 4, 4, 16
TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, backbone="resnet18", dropout=0.0)
T_STEPS = 6  # LayoutDM's denoising steps
TOP_P = SamplingConfig(name="top_p", top_p=0.9)
CLOCK_NS = 1_000_000  # a record against its Kineto annotation: within 1 ms


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def tokenizer(special=("pad", "bos", "eos")) -> LayoutSequenceTokenizer:
    return LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=S, num_bin=16,
                                                   special_tokens=special))


def loader(train, retriever, prefetch=0, seed=0):
    return RetrievalAugmentedLoader(
        BatchLoader(train, B, shuffle=seed is not None, seed=seed or 0, use_native=False,
                    prefetch=prefetch), retriever, K, is_train_split=True)


@pytest.fixture(scope="module")
def data():
    """(the synthetic split, its retriever, one retrieval-augmented batch)."""
    train = SyntheticPosterDataset(DatasetConfig(name="synthetic"), N, 0, HW)
    retriever = Retriever.build(train, device="cpu")
    return train, retriever, next(iter(loader(train, retriever, seed=None)))


def ralf() -> RALFGenerator:
    return RALFGenerator(tokenizer(), GeneratorConfig(**TINY), "uncond", image_hw=HW, top_k=K,
                         device="cpu")


def layoutdm() -> LayoutDMGenerator:
    return LayoutDMGenerator(tokenizer(("pad", "mask")), GeneratorConfig(**TINY),
                             num_timesteps=T_STEPS, image_hw=HW, device="cpu")


def request(gen, batch, task=None, seed=3):
    """The calls `cli.inference` makes a batch: (condition, layout arrays, tokens)."""
    cond, _ = gen.build_condition(batch, np.random.default_rng(seed), task=task)
    layout, seq = gen.sample(cond, TOP_P, torch.Generator().manual_seed(seed),
                             return_tokens=True)
    calculate_violation(cond, seq, layout, gen.tokenizer)
    return cond, layout.numpy(), seq


def by_name(records) -> dict:
    out = collections.defaultdict(list)
    for r in sorted(records, key=lambda r: r.start_ns):
        out[r.name].append(r)
    return out


def assert_same(a, b) -> None:
    (_, layout_a, seq_a), (_, layout_b, seq_b) = a, b
    assert torch.equal(seq_a, seq_b)
    for k in layout_a:
        np.testing.assert_array_equal(layout_a[k], layout_b[k])


# ---- the switch -------------------------------------------------------------------------


def test_tracing_off_records_nothing_reads_no_clock_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(tracing._autograd_profiler, "record_function",
                        lambda *a, **k: opened.append(a))
    assert not tracing.profiler_recording()
    with monkeypatch.context() as m:
        m.setattr(time, "time_ns", lambda: opened.append("clock"))
        first, second = tracing.span("a"), tracing.span("b", device=True)
        with first:
            with second:
                tracing.count("c", 3)
                tracing.count_h2d(np.zeros(8))
    assert first is second  # one shared no-op context
    assert opened == [] and tracing.records() == []
    assert not any(k == "c" or k.startswith("h2d.") for k in tracing.counters())


def test_a_torch_profiler_turns_the_spans_on_by_itself():
    """Fails if torch renames the module flag that `profiler_recording` reads."""
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.profiler_recording()
        with tracing.span("outer"):
            with tracing.span("inner"):
                tracing.count("c", 2)
    assert not tracing.profiler_recording()
    with tracing.span("after"):
        pass
    got = by_name(tracing.records())
    assert sorted(got) == ["inner", "outer"]
    (outer,), (inner,) = got["outer"], got["inner"]
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == outer.id and inner.root == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert tracing.counters()["c"] == 2


def test_each_thread_keeps_its_own_parents_and_the_store_is_bounded(monkeypatch):
    tracing.enable()
    with tracing.span("main"):

        def other():
            with tracing.span("other"):
                pass

        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    got = by_name(tracing.records())
    assert got["other"][0].parent is None and got["other"][0].root == got["other"][0].id

    tracing.reset()
    monkeypatch.setattr(tracing.TRACER, "limit", 3)
    for _ in range(5):
        with tracing.span("x"):
            pass
    assert len(tracing.records()) == 3 and tracing.TRACER.dropped == 2
    assert tracing.summary()["dropped"] == 2


def test_summary_and_counters_read_the_existing_counters(tmp_path):
    from ralf_tpu_torch.ops.encoder_attention import encoder_attention

    tracing.enable()
    for _ in range(4):
        with tracing.span("x"):
            time.sleep(0.001)
    s = tracing.summary()
    x = s["spans"]["x"]
    assert x["count"] == 4 and 1.0 <= x["host_ms_median"] <= x["host_ms_p95"]
    assert "device_ms_median" not in x  # no CUDA events on the CPU
    assert s["counters"]["launches.encoder_attention"] == encoder_attention.launches
    assert all(f"launches.{attr}" in s["counters"] for _, attr in tracing.LAUNCH_COUNTERS)
    tracing.write_summary(str(tmp_path))
    assert json.loads((tmp_path / tracing.SUMMARY_FILE).read_text())["spans"]["x"]["count"] == 4


def test_h2d_counters_take_numpy_as_pageable_and_a_pinned_tensor_as_pinned():
    tracing.enable()
    host = torch.zeros(5, 7)
    pinned = torch.zeros(3, dtype=torch.float64)
    pinned.is_pinned = lambda: True  # a CPU-only build cannot pin
    tracing.count_h2d(np.zeros((4, 6), np.uint8))
    tracing.count_h2d(host)
    tracing.count_h2d(pinned)
    tracing.count_h2d(torch.zeros(9, device="meta"))  # already on a device: no copy
    c = tracing.counters()
    assert c["h2d.pageable_bytes"] == 24 + 5 * 7 * 4
    assert c["h2d.pinned_bytes"] == 3 * 8


# ---- the layers ---------------------------------------------------------------------------


def test_ralf_request_spans_bytes_and_tokens(data):
    _, _, batch = data
    gen = ralf()
    off = request(gen, batch)
    assert tracing.records() == []
    tracing.enable()
    on = request(gen, batch)
    tracing.disable()
    assert_same(off, on)

    got = by_name(tracing.records())
    L = gen.tokenizer.max_token_length
    assert {k: len(v) for k, v in got.items()} == {
        "gen.condition": 1, "gen.encode": 1, "ar.decode": 1, "ar.decode.layers": L,
        "ar.decode.sample": L, "eval.violations": 1}
    (decode,) = got["ar.decode"]
    steps = sorted(got["ar.decode.layers"] + got["ar.decode.sample"], key=lambda r: r.start_ns)
    assert [r.name for r in steps] == ["ar.decode.layers", "ar.decode.sample"] * L
    assert all(r.parent == decode.id and r.root == decode.id for r in steps)
    assert all(a.end_ns <= b.start_ns for a, b in zip(steps, steps[1:]))
    assert got["gen.encode"][0].events is None and got["gen.encode"][0].device_ms is None

    cond = on[0]
    want = (np.asarray(cond.image).nbytes
            + sum(np.asarray(cond.retrieved[k]).nbytes for k in RETRIEVED_KEYS)
            + np.asarray(cond.const_seq).nbytes + np.asarray(cond.const_mask).nbytes
            + build_forced_tokens(cond, gen.tokenizer).nbytes)
    c = tracing.counters()
    assert c["h2d.pageable_bytes"] == want and "h2d.pinned_bytes" not in c


def test_layoutdm_request_spans_bytes_and_tokens(data):
    _, _, batch = data
    batch = {k: batch[k] for k in ("layout", "image", "id")}
    gen = layoutdm()
    off = request(gen, batch, task="c")
    tracing.enable()
    on = request(gen, batch, task="c")
    tracing.disable()
    assert_same(off, on)

    got = by_name(tracing.records())
    assert {k: len(v) for k, v in got.items()} == {
        "gen.condition": 1, "gen.encode": 1, "zoo.denoise": 1, "zoo.denoise.decoder": T_STEPS,
        "zoo.denoise.posterior": T_STEPS, "eval.violations": 1}
    (loop,) = got["zoo.denoise"]
    steps = sorted(got["zoo.denoise.decoder"] + got["zoo.denoise.posterior"],
                   key=lambda r: r.start_ns)
    assert [r.name for r in steps] == ["zoo.denoise.decoder", "zoo.denoise.posterior"] * T_STEPS
    assert all(r.parent == loop.id for r in steps)
    assert got["gen.encode"][0].end_ns <= loop.start_ns

    cond = on[0]
    L = gen.tokenizer.max_token_length
    want = (np.asarray(cond.image).nbytes + np.asarray(cond.seq).nbytes
            + np.asarray(cond.seq_mask).nbytes + B * L)  # pad_disable: bool [B, L]
    assert tracing.counters()["h2d.pageable_bytes"] == want


def assert_same_tree(a, b) -> None:
    if isinstance(a, (dict, tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for ka, kb in zip(sorted(a) if isinstance(a, dict) else a,
                          sorted(b) if isinstance(b, dict) else b):
            if isinstance(a, dict):
                assert ka == kb
                assert_same_tree(a[ka], b[kb])
            else:
                assert_same_tree(ka, kb)
    else:
        np.testing.assert_array_equal(a, b)


def fit(data, job_dir, steps=2):
    train, retriever, _ = data
    gen = ralf()
    Trainer(gen, TrainConfig(job_dir=str(job_dir), batch_size=B, epochs=1)).fit(
        loader(train, retriever, prefetch=2), None, num_steps_cap=steps)
    with open(job_dir / "metrics.jsonl") as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    return losses, export_params(gen.core)


def test_train_step_spans_and_the_same_training(data, tmp_path):
    off = fit(data, tmp_path / "off")
    tracing.enable()
    on = fit(data, tmp_path / "on")
    tracing.disable()
    assert off[0] == on[0]
    assert_same_tree(off[1], on[1])

    got = by_name(tracing.records())
    for name in ("train.step", "train.forward", "train.backward", "train.clip"):
        assert len(got[name]) == 2, name
    assert len(got["data.loader_wait"]) >= 2 and len(got["data.retrieval"]) >= 2
    records = sorted(tracing.records(), key=lambda r: r.start_ns)
    for step in got["train.step"]:
        assert step.parent is None
        assert [r.name for r in records if r.parent == step.id] == [
            "gen.condition", "train.forward", "train.backward", "train.clip"]
    for r in got["data.loader_wait"] + got["data.retrieval"]:
        assert r.parent is None  # the loader runs between steps


# ---- the clock ----------------------------------------------------------------------------


def test_every_record_lies_on_kinetos_clock_beside_its_annotation(data):
    _, _, batch = data
    gen = layoutdm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        request(gen, {k: batch[k] for k in ("layout", "image", "id")})
    annotations = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == DeviceType.CPU:
            annotations[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    got = by_name(tracing.records())
    assert got and sum(len(v) for v in got.values()) == 3 + 2 * T_STEPS + 1
    for name, recs in got.items():
        spans = sorted(annotations[name])
        assert len(spans) == len(recs), name
        for r, (s, e) in zip(recs, spans):
            assert abs(r.start_ns - s) <= CLOCK_NS and abs(r.end_ns - e) <= CLOCK_NS, name
            assert r.start_ns <= s and e <= r.end_ns, name  # read outside the range


def test_a_profile_steps_chrome_trace_carries_the_spans(data, tmp_path):
    train, retriever, _ = data
    cfg = TrainConfig(job_dir=str(tmp_path), batch_size=B, epochs=1, profile_steps=(0, 1))
    Trainer(ralf(), cfg).fit(loader(train, retriever), None, num_steps_cap=2)
    with open(tmp_path / "profile" / "trace.json") as f:
        names = collections.Counter(e.get("name") for e in json.load(f)["traceEvents"]
                                     if e.get("cat") == "user_annotation")
    for name in ("train.step", "train.forward", "train.backward", "train.clip"):
        assert names[name] == 2, name


# ---- the operator's surface -----------------------------------------------------------------

CLI_TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
            "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
            "generator_kwargs.top_k=4"]


def test_the_clis_trace_flag_writes_the_summary_and_leaves_tracing_off(tmp_path):
    from ralf_tpu_torch.cli import inference, train

    job = tmp_path / "job"
    common = ["--device", "cpu"]
    train.main(["--experiment", "ralf", "--synthetic", "--debug", "--trace", "--job-dir",
                str(job), "--batch-size", "8", "--cache-dir", str(tmp_path / "cache"),
                *common, *CLI_TINY])
    assert not tracing.TRACER.enabled
    spans = json.loads((job / tracing.SUMMARY_FILE).read_text())["spans"]
    assert spans["train.step"]["count"] == spans["train.forward"]["count"] == 2

    out = inference.main(["--job-dir", str(job), "--cond", "c", "--num-seeds", "1", "--trace",
                          *common])
    assert not tracing.TRACER.enabled
    s = json.loads((tmp_path / out["out_dir"] / tracing.SUMMARY_FILE).read_text())
    n = s["spans"]["infer.batch"]["count"]
    assert n >= 1 and s["spans"]["ar.decode"]["count"] == n
    assert s["spans"]["ar.decode.layers"]["count"] == 50 * n  # 5 tokens x 10 elements a row
    assert s["counters"]["h2d.pageable_bytes"] > 0

    tracing.reset()
    untraced = inference.main(["--job-dir", str(job), "--cond", "c", "--num-seeds", "1",
                               "--out-dir", str(tmp_path / "plain"), *common])
    assert not (tmp_path / "plain" / tracing.SUMMARY_FILE).exists()
    assert untraced["out_dir"] == str(tmp_path / "plain") and tracing.records() == []
