"""What the families that serve layouts share: the port's tokenizer of a
configuration, the sample of served rows that the reference judges, and
the checks on every request and every sampled row."""

from __future__ import annotations

import numpy as np

from benchmark.lib.weights import subseed

GEO_KEYS = ("center_x", "center_y", "width", "height")


def tokenizer(config: dict, kmeans_centers: dict | None = None):
    """The port's LayoutSequenceTokenizer of the configuration."""
    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig

    d, t = config["dataset"], config["tokenizer"]
    return LayoutSequenceTokenizer(TokenizerConfig(
        num_labels=d["num_labels"], max_seq_length=d["max_seq_length"], num_bin=t["num_bin"],
        special_tokens=tuple(t["special_tokens"]), geo_quantization=t["geo_quantization"],
        kmeans_centers=kmeans_centers))


def sample_rows(records: list, rows: int, seed: int) -> list:
    """(record, row) pairs of greedy requests: the row with the most
    elements served, then others drawn from the seed."""
    greedy = [r for r in records if r.greedy]
    pairs = [(r, i) for r in greedy for i in range(r.tokens.shape[0])]
    if not pairs:
        return []
    counts = np.concatenate([r.layout["mask"].sum(1) for r in greedy])
    first = int(np.argmax(counts))
    rng = np.random.default_rng(subseed(seed, "check"))
    rest = [j for j in rng.permutation(len(pairs)) if j != first][: rows - 1]
    return [pairs[first]] + [pairs[j] for j in rest]


def release(torch, prog) -> None:
    """Free the program's state before the reference runs on the card, and
    keep the reference's float32 products out of TF32."""
    prog.gen = prog.batches = None
    if prog.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def illegal_tokens(records: list, allowed: np.ndarray) -> int:
    """Tokens of every request that `allowed` [L, V] forbids at their position."""
    return sum(illegal_in(r.tokens, allowed) for r in records)


def illegal_in(tokens: np.ndarray, allowed: np.ndarray) -> int:
    """Tokens [B, L] that `allowed` [L, V] forbids at their position."""
    pos = np.arange(allowed.shape[0])[None, :]
    return int((~allowed[pos, np.asarray(tokens)]).sum())


def layout_mismatches(chosen: list, decoded: list) -> int:
    """Sampled rows whose served layout differs from the reference's
    decoding of their tokens (labels and masks exactly, geometry to 1e-6)."""
    bad = 0
    for (r, i), want in zip(chosen, decoded):
        got = {k: r.layout[k][i : i + 1] for k in want}
        same = all(np.array_equal(want[k], got[k]) for k in ("label", "mask")) and all(
            np.allclose(want[k], got[k], rtol=0, atol=1e-6) for k in GEO_KEYS)
        bad += 0 if same else 1
    return bad


def gap_figures(gaps) -> dict:
    """Three readings of the gaps [rows, L] of a sample (None without one):
    the mean over its tokens, the mean over its rows of each row's widest
    gap, and the widest."""
    if gaps is None:
        return {"mean_gap": None, "row_gap": None, "max_gap": None}
    return {"mean_gap": float(gaps.mean()), "row_gap": float(gaps.amax(1).mean()),
            "max_gap": float(gaps.max())}


def gap_checks(gaps, limits: dict, illegal: int, mismatch: int, missing: int):
    """(info, checks) from the sampled tokens' gaps [rows, L] (None when no
    row was sampled): the gap figures named in `limits` are compared, the
    others printed."""
    figures = gap_figures(gaps)
    info = {k: v for k, v in figures.items() if k not in limits}
    info["tokens_compared"] = 0 if gaps is None else gaps.numel()
    compared = {k: {"value": figures[k], "limit": lim} for k, lim in limits.items()}
    return info, {**compared,
                  "layout_mismatch": {"value": mismatch, "limit": 0},
                  "illegal_tokens": {"value": illegal, "limit": 0},
                  "rows_missing": {"value": missing, "limit": 0}}
