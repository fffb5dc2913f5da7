"""Datasets and the fixed-shape batch iterator, the counterpart of
`ralf_tpu/data/dataset.py`.  Host-side numpy: the same seeds and files give
the same layouts, canvases and batches as the JAX package.

  * SyntheticPosterDataset: deterministic procedural posters with saliency;
  * HFParquetDataset: the reference's parquet dumps (HF `datasets` format),
    layouts padded once, images decoded per batch;
  * unannotated_dataset: the dump's `with_no_annotation` split, or a
    fallback when it is absent;
  * BatchLoader: batches of padded layouts (the native collator, or the
    numpy transforms), ids, indices and canvases, optionally built ahead on
    a producer thread.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.data.transforms import compose
from ralf_tpu_torch.utils import tracing

IMAGE_H, IMAGE_W = 350, 240  # the reference canvas (H x W)
PKU_LABELS = ("logo", "text", "underlay")
CGL_LABELS = ("embellishment", "logo", "text", "underlay")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str = "pku10"
    data_dir: Optional[str] = None  # parquet dump root (HFParquetDataset); None -> synthetic
    max_seq_length: int = 10
    image_h: int = IMAGE_H
    image_w: int = IMAGE_W

    @property
    def label_names(self) -> Sequence[str]:
        if "pku" in self.name:  # tested first, as in JAX: a name with both is PKU
            return PKU_LABELS
        if "cgl" in self.name:
            return CGL_LABELS
        return PKU_LABELS

    @property
    def num_labels(self) -> int:
        return len(self.label_names)


class SyntheticPosterDataset:
    """Deterministic procedural posters: 1..S boxes; the image is a smooth
    colour gradient with box-shaped brightness bumps, the saliency channel
    the union of the boxes."""

    def __init__(self, cfg: DatasetConfig, size: int, seed: int = 0,
                 image_hw: tuple[int, int] | None = None) -> None:
        self.cfg = cfg
        self._size = size
        self._seed = seed
        self._hw = image_hw or (cfg.image_h, cfg.image_w)
        S = cfg.max_seq_length
        rng = np.random.default_rng(seed)
        n = rng.integers(1, S + 1, size=size)
        mask = np.arange(S)[None, :] < n[:, None]
        label = rng.integers(0, cfg.num_labels, size=(size, S))
        cx = rng.uniform(0.1, 0.9, (size, S))
        cy = rng.uniform(0.1, 0.9, (size, S))
        w = rng.uniform(0.08, 0.5, (size, S))
        h = rng.uniform(0.04, 0.3, (size, S))
        z = np.zeros_like(cx)
        self._data = {
            "label": np.where(mask, label, 0).astype(np.int64),
            "center_x": np.where(mask, cx, z).astype(np.float32),
            "center_y": np.where(mask, cy, z).astype(np.float32),
            "width": np.where(mask, w, z).astype(np.float32),
            "height": np.where(mask, h, z).astype(np.float32),
            "mask": mask,
        }

    def __len__(self) -> int:
        return self._size

    def get_layouts(self, indices: np.ndarray) -> dict:
        return {k: v[indices] for k, v in self._data.items()}

    def get_ids(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(indices, np.int64)

    def get_images(self, indices: np.ndarray, dtype=np.float32) -> np.ndarray:
        """[N, H, W, 4] RGB + saliency: float32 in [0, 1], or uint8 with
        dtype=np.uint8.  Bit for bit JAX's canvases: a box's comparisons
        against the 2-D grid are those against its 1-D rows and columns, so
        each box touches only its rectangle (elsewhere JAX adds 0 and takes
        the max with 0); canvases are made on threads when there are many."""
        H, W = self._hw
        out = np.empty((len(indices), H, W, 4), np.float32)
        ys = np.linspace(0, 1, H, dtype=np.float32)
        xs = np.linspace(0, 1, W, dtype=np.float32)
        grid = np.add.outer(ys, xs)  # xx + yy of the meshgrid

        def canvas(o: int) -> None:
            idx = int(indices[o])
            rng = np.random.default_rng(self._seed * 1_000_003 + idx)
            phase = rng.uniform(0, 2 * np.pi, 3)
            freq = rng.uniform(1.0, 3.0, 3)
            rgb = 0.5 + 0.35 * np.stack(
                [np.sin(2 * np.pi * f * grid + p) for f, p in zip(freq, phase)], axis=-1)
            sal = out[o, ..., 3]
            sal[:] = 0.0
            lay = {k: self._data[k][idx] for k in self._data}
            for e in range(self.cfg.max_seq_length):
                if not lay["mask"][e]:
                    continue
                l = lay["center_x"][e] - lay["width"][e] / 2
                r = lay["center_x"][e] + lay["width"][e] / 2
                t = lay["center_y"][e] - lay["height"][e] / 2
                b = lay["center_y"][e] + lay["height"][e] / 2
                rows = np.flatnonzero((ys >= t) & (ys <= b))
                cols = np.flatnonzero((xs >= l) & (xs <= r))
                if not len(rows) or not len(cols):
                    continue
                box = (slice(rows[0], rows[-1] + 1), slice(cols[0], cols[-1] + 1))
                sal[box] = 1.0
                inside = np.ones((len(rows), len(cols), 1), np.float32)
                rgb[box] += 0.15 * inside * (lay["label"][e] + 1) / 4.0
            out[o, ..., :3] = np.clip(rgb, 0, 1)

        workers = min(8, os.cpu_count() or 1)
        if workers > 1 and len(indices) >= 2 * workers:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(workers) as pool:
                list(pool.map(canvas, range(len(indices))))
        else:
            for o in range(len(indices)):
                canvas(o)
        if dtype == np.uint8:
            return (out * 255.0 + 0.5).astype(np.uint8)
        return out


class HFParquetDataset:
    """Reader for the reference's parquet dumps (HF datasets format): the
    records of `{data_dir}/{split}/*.parquet` with `id`, `image`, `saliency`
    (PNG) and per-element `label`, `center_x`, `center_y`, `width`,
    `height`.  Layouts are padded into numpy once; images decode per batch.
    It needs the `datasets` package (with pyarrow) and PIL, imported here,
    not when the module is imported.
    """

    def __init__(self, cfg: DatasetConfig, split: str = "train") -> None:
        if not cfg.data_dir:
            raise ValueError("HFParquetDataset: DatasetConfig.data_dir is not set")
        try:
            import datasets as hfds
            import PIL  # noqa: F401  (get_images decodes with it)
        except ImportError as e:
            raise ImportError(
                "HFParquetDataset reads parquet dumps through the `datasets` package "
                "(with pyarrow) and decodes images with PIL; install them where real "
                "data is read, or use the synthetic dataset") from e

        self.cfg = cfg
        path = os.path.join(cfg.data_dir, split)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"HFParquetDataset: no split directory {path}")
        self._ds = hfds.load_dataset(
            "parquet",
            data_files={split: os.path.join(path, "*.parquet")},
            split=split,
        )
        S = cfg.max_seq_length
        n = len(self._ds)
        self._layouts = {
            k: np.zeros((n, S), np.float32)
            for k in ("center_x", "center_y", "width", "height")
        }
        self._layouts["label"] = np.zeros((n, S), np.int64)
        self._layouts["mask"] = np.zeros((n, S), bool)
        self._ids = []
        cols = self._ds.with_format("numpy")
        for i, rec in enumerate(cols):
            m = min(len(rec["label"]), S)
            self._layouts["label"][i, :m] = rec["label"][:m]
            for k in ("center_x", "center_y", "width", "height"):
                self._layouts[k][i, :m] = rec[k][:m]
            self._layouts["mask"][i, :m] = True
            self._ids.append(rec.get("id", i))
        self._ids = np.asarray(self._ids)

    def __len__(self) -> int:
        return len(self._ds)

    def get_layouts(self, indices: np.ndarray) -> dict:
        return {k: v[indices] for k, v in self._layouts.items()}

    def get_ids(self, indices: np.ndarray) -> np.ndarray:
        return self._ids[indices]

    def get_images(self, indices: np.ndarray,
                   dtype=np.float32) -> np.ndarray:
        """[N, H, W, 4] RGB + saliency, float32 in [0, 1] or uint8 with
        dtype=np.uint8.  One arrow fetch for the whole index list: the
        encoded PNG bytes come straight off the arrow columns, decode into a
        preallocated uint8 buffer (on threads when the batch is large), and
        the [0, 1] scaling is one vectorized pass."""
        import io

        from PIL import Image as PILImage

        H, W = self.cfg.image_h, self.cfg.image_w
        idx = [int(i) for i in indices]
        imgs = self._ds.data.column("image").take(idx).to_pylist()
        sals = self._ds.data.column("saliency").take(idx).to_pylist()

        def _decode(rec, mode):
            if isinstance(rec, dict):
                src = (io.BytesIO(rec["bytes"]) if rec.get("bytes")
                       else rec["path"])
                im = PILImage.open(src).convert(mode)
            else:  # already decoded (in-memory dataset)
                im = rec if hasattr(rec, "convert") else PILImage.fromarray(
                    np.asarray(rec))
                im = im.convert(mode)
            if im.size != (W, H):
                im = im.resize((W, H))
            return np.asarray(im)

        u8 = np.empty((len(idx), H, W, 4), np.uint8)

        def _fill(o: int) -> None:
            u8[o, ..., :3] = _decode(imgs[o], "RGB")
            u8[o, ..., 3] = _decode(sals[o], "L")

        # PNG decode releases the GIL: threads write disjoint rows of the buffer
        workers = min(8, os.cpu_count() or 1)
        if workers > 1 and len(idx) >= 2 * workers:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(workers) as pool:
                list(pool.map(_fill, range(len(idx))))
        else:
            for o in range(len(idx)):
                _fill(o)
        if dtype == np.uint8:
            return u8
        out = u8.astype(np.float32)
        out *= np.float32(1.0 / 255.0)
        return out


def unannotated_dataset(cfg: DatasetConfig, fallback, split: str):
    """The `with_no_annotation` split of the parquet dump; the split's own
    canvases (`fallback`) only when that split is absent: no data_dir, no
    such directory, or no parquet reader installed.  Any other error raises."""
    root = cfg.data_dir
    if not root or not os.path.isdir(os.path.join(root, "with_no_annotation")):
        logging.warning("no with_no_annotation split under %r; using the %s canvases", root, split)
        return fallback
    try:
        return HFParquetDataset(cfg, "with_no_annotation")
    except ImportError as e:
        logging.warning("%s; using the %s canvases", e, split)
        return fallback


class BatchLoader:
    """Shuffling fixed-shape batch iterator with instance transforms:
    batches {'layout': Layout (CPU tensors), 'id', 'indices', 'image'}.

    As in JAX: the last partial batch is dropped unless drop_last=False; with
    use_native (the default) the C++ collator (`data/native.py`) applies the
    transforms, seeded by one draw of the loader's rng per batch, so the rng
    stream, and with it the next epoch's permutation, is the JAX loader's; a
    failed native build raises, and use_native=False takes the numpy path.
    prefetch > 0 builds that many batches ahead on a producer thread, whose
    errors are raised in the consumer.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 transforms: Sequence[str] = ("sort_label", "sort_lexicographic"),
                 drop_last: bool = True, seed: int = 0, with_images: bool = True,
                 use_native: bool = True, prefetch: int = 2,
                 image_dtype=np.float32) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.with_images = with_images
        self.use_native = use_native
        self.prefetch = prefetch
        self.image_dtype = image_dtype
        self.transforms = list(transforms)
        self._transform = compose(self.transforms)  # an unknown name raises here
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def _apply_transforms(self, lay: dict) -> dict:
        if self.use_native and self.transforms:
            from ralf_tpu_torch.data import native

            return native.collate_batch(lay, self.transforms, int(self._rng.integers(2**63)))
        out = {k: v.copy() for k, v in lay.items()}
        for b in range(lay["label"].shape[0]):
            n = int(lay["mask"][b].sum())
            if n <= 1:
                continue
            sample = {k: lay[k][b, :n] for k in ("label", "center_x", "center_y", "width", "height")}
            for k, v in self._transform(sample, self._rng).items():
                out[k][b, :n] = v
        return out

    def _batches(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        b = self.batch_size
        stop = n - n % b if self.drop_last else n
        for s in range(0, stop, b):
            idx = order[s : s + b]
            lay = self._apply_transforms(self.dataset.get_layouts(idx))
            batch = {"layout": Layout.fromdict(lay), "id": self.dataset.get_ids(idx),
                     "indices": idx}
            if self.with_images:
                batch["image"] = self.dataset.get_images(idx, dtype=self.image_dtype)
            yield batch

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        end = object()

        def producer() -> None:
            try:
                for batch in self._batches():
                    q.put(batch)
                q.put(end)
            except BaseException as e:  # handed to the consumer, which raises it
                q.put(_ProducerError(e))

        threading.Thread(target=producer, daemon=True).start()
        while True:
            with tracing.span("data.loader_wait"):
                item = q.get()
            if item is end:
                return
            if isinstance(item, _ProducerError):
                raise item.error
            yield item


class _ProducerError:
    def __init__(self, error: BaseException) -> None:
        self.error = error
