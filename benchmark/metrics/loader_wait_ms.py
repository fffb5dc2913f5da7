"""Median host time the step loop waits for the loader's next batch
(`next` on the port's RetrievalAugmentedLoader over its BatchLoader)."""

LAYER = "host data"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(run):
    return run.spans.median("loader")
