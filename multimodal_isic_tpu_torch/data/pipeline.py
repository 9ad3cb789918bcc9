"""Input pipeline: host decode → card (prefetched) → transform on the card.

Counterpart of ``multimodal_isic_tpu/data/pipeline.py``.  The host does only
what must touch bytes on disk (JPEG decode and the centroid crop); resize,
augmentation and normalisation run batched on the card.

- ``DermRecords`` (:29-143) reads a manifest's records: decode + centroid
  crop to the 450² staging size, with the native decoder
  (``data/native_io.py``) where it loads and cv2 otherwise, an optional host
  cache of decoded crops, metadata-only records (``with_image=False``) and
  the 102-wide radiomics placeholder.
- ``DeviceLoader`` (:224-339) streams batches: a producer thread decodes
  (one threaded native call a batch), puts the arrays in pinned memory and
  copies them to the card with ``non_blocking=True`` on a side CUDA stream;
  the consumer's stream waits on the copy's event before it reads them.
- ``DeviceDataset`` (:148-221) stages a split on the card once, from
  in-memory crops or from a ``DermRecords``; each epoch then gathers and
  augments its batches on the card.

Several processes: a rank's loader gets its rows of each global batch as
``order`` and its share of the batch as ``batch_size``
(``parallel.distributed.process_epoch_order``).  JAX's ``place`` hook
(:231-247,316-333) assembles global arrays from the processes' rows; the
port has no global array (a rank computes on its rows and the steps
reduce explicitly), so the loader has no such hook.

Integer columns become int64, the index type of ``nn.Embedding`` and
``F.cross_entropy``.  cv2 is imported where a record is decoded with it.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import native_io
from .crop import centroid_crop
from .manifest import ARTIFACT_COLS

RADIOMICS_PLACEHOLDER_DIM = 102  # reference stub at dataset.py:42
UPLOAD_BATCH = 256  # records decoded a batch by DeviceDataset.from_records
PREFETCH = 2  # host batches DeviceLoader decodes ahead of its consumer

Device = Union[str, torch.device]


class DermRecords:
    """Host-side record reader: decode + centroid crop, no augmentation.

    ``staging_hw`` fixes the host output size so batches have one shape:
    crops whose ``min(H, W)`` differs from it are resized on the host
    (cv2 INTER_LINEAR, masks INTER_NEAREST).  ``cache_decoded=True`` keeps
    each decoded crop in host memory after its first read, so later epochs
    skip the decode.  ``with_image=False`` gives metadata-only records (no
    decode, no image or mask keys).  ``use_native=None`` picks the native
    decoder where it loads.
    """

    def __init__(self, df, radiomics=None, staging_hw=(450, 450),
                 use_native: Optional[bool] = None, with_image: bool = True,
                 cache_decoded: bool = False):
        self.df = df.reset_index(drop=True)
        self._cache: Optional[dict] = {} if cache_decoded else None
        self.with_image = with_image
        self.radiomics = None
        if radiomics is not None:
            self.radiomics = np.asarray(radiomics, dtype=np.float32)
            if len(self.radiomics) != len(self.df):
                raise ValueError("radiomics rows must align with manifest rows")
        self.staging_hw = tuple(staging_hw)
        if use_native is None:
            use_native = native_io.available()
        self.use_native = use_native

    def __len__(self):
        return len(self.df)

    @property
    def radiomics_dim(self) -> int:
        """The width of the radiomics column these records give."""
        return (self.radiomics.shape[1] if self.radiomics is not None
                else RADIOMICS_PLACEHOLDER_DIM)

    def read_image_mask(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        row = self.df.iloc[idx]
        if self.use_native:
            out = native_io.decode_crop(row["image_path"],
                                        str(row["segmentation_path"]),
                                        self.staging_hw)
        else:
            out = self._read_cv2(row["image_path"], row["segmentation_path"])
        if self._cache is not None:
            self._cache[idx] = out
        return out

    def _read_cv2(self, image_path: str, mask_path):
        import cv2  # local: host-only dependency

        bgr = cv2.imread(image_path)
        if bgr is None:
            raise FileNotFoundError(image_path)
        image = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if mask_path == "no_mask" or not os.path.exists(str(mask_path)):
            mask = None
        else:
            mask = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
            if mask.shape[:2] != image.shape[:2]:
                mask = cv2.resize(mask, image.shape[1::-1],
                                  interpolation=cv2.INTER_NEAREST)
        image, mask = centroid_crop(image, mask)  # min(H, W) square
        if image.shape[:2] != self.staging_hw:
            size = self.staging_hw[::-1]
            image = cv2.resize(image, size, interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, size, interpolation=cv2.INTER_NEAREST)
        return image, mask

    def metadata(self, idx: int) -> Dict[str, np.ndarray]:
        """The non-image fields of a record (no decode)."""
        row = self.df.iloc[idx]
        if self.radiomics is not None:
            radiomics = self.radiomics[idx]
        else:
            radiomics = np.zeros(RADIOMICS_PLACEHOLDER_DIM, np.float32)
        has_art = all(c in row.index for c in ARTIFACT_COLS)
        return {
            "radiomics": radiomics,
            "age": np.float32(row.get("age_normalized", 0.0)),
            "sex": np.int32(row.get("sex_encoded", 0)),
            "loc": np.int32(row.get("loc_encoded", 0)),
            "artifacts": (row[ARTIFACT_COLS].values.astype(np.int32)
                          if has_art else np.zeros(len(ARTIFACT_COLS),
                                                   np.int32)),
            "target": np.int32(row["dx"]),
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if not self.with_image:
            return self.metadata(idx)
        image, mask = self.read_image_mask(idx)
        return {"image": image, "mask": mask, **self.metadata(idx)}


def _collate(samples: Sequence[Dict[str, np.ndarray]]
             ) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _tensor(v: np.ndarray) -> torch.Tensor:
    """A host column as a CPU tensor; integers as int64."""
    v = np.ascontiguousarray(v)
    if np.issubdtype(v.dtype, np.integer) and v.dtype != np.uint8:
        v = v.astype(np.int64)
    return torch.from_numpy(v)


class DeviceDataset:
    """A split staged on the card once, for device-resident epochs.

    Built from in-memory uint8 crops [N, H, W, 3] and a metadata dict of
    per-row columns, or with :meth:`from_records` from a ``DermRecords``.
    ``with_masks=False`` stages no masks: the fusion train step never reads
    them, so the fast policy (which passes masks through) needs none.
    """

    def __init__(self, images: np.ndarray, meta: Dict[str, np.ndarray],
                 masks: Optional[np.ndarray] = None,
                 device: Device = "cuda", with_masks: bool = True):
        if with_masks and masks is None:
            raise ValueError("with_masks=True needs masks")
        n = len(images)
        if any(len(v) != n for v in meta.values()):
            raise ValueError("every metadata column needs one row per image")
        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        self.masks = (torch.from_numpy(np.ascontiguousarray(masks)).to(
            self.device) if with_masks else None)
        self.meta = {k: _tensor(v).to(self.device) for k, v in meta.items()}

    @classmethod
    def from_records(cls, records: DermRecords, device: Device = "cuda",
                     with_masks: bool = True) -> "DeviceDataset":
        """Stage every record of ``records`` (JAX ``DeviceDataset(records,
        with_masks=…)``): decoded in batches of ``UPLOAD_BATCH`` and copied
        into one tensor on the card."""
        self = cls.__new__(cls)
        self.device = torch.device(device)
        n, (h, w) = len(records), records.staging_hw
        self.images = torch.empty((n, h, w, 3), dtype=torch.uint8,
                                  device=self.device)
        self.masks = (torch.empty((n, h, w), dtype=torch.uint8,
                                  device=self.device) if with_masks else None)
        helper = DeviceLoader(records, UPLOAD_BATCH, device=self.device)
        start = 0
        for host in helper._host_batches():
            stop = start + len(host["image"])
            self.images[start:stop].copy_(torch.from_numpy(host["image"]))
            if with_masks:
                self.masks[start:stop].copy_(torch.from_numpy(host["mask"]))
            start = stop
        meta = _collate([records.metadata(i) for i in range(n)])
        self.meta = {k: _tensor(v).to(self.device) for k, v in meta.items()}
        return self

    def __len__(self) -> int:
        return len(self.images)

    def epoch_order(self, batch_size: int,
                    order: Optional[np.ndarray] = None) -> np.ndarray:
        """(n_steps, batch_size) int32 gather indices for the
        device-resident epoch (``train.fusion.make_fusion_train_epoch``);
        drops the final partial batch."""
        order = np.arange(len(self)) if order is None else np.asarray(order)
        n = (len(order) // batch_size) * batch_size
        return order[:n].reshape(-1, batch_size).astype(np.int32)

    def loader(self, batch_size: int, order: Optional[np.ndarray] = None,
               transform: Optional[Callable] = None, rng_stream=None,
               drop_last: bool = False) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of device-resident batches (device gather → transform,
        called as ``transform(images, masks[, generator])`` with a generator
        from ``rng_stream`` when one is given)."""
        order = np.arange(len(self)) if order is None else np.asarray(order)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            idx_d = torch.as_tensor(idx, dtype=torch.long, device=self.device)
            batch = {k: v.index_select(0, idx_d) for k, v in self.meta.items()}
            images = self.images.index_select(0, idx_d)
            masks = (self.masks.index_select(0, idx_d)
                     if self.masks is not None else None)
            if transform is not None:
                if rng_stream is not None:
                    images, masks = transform(images, masks, rng_stream.next())
                else:
                    images, masks = transform(images, masks)
            batch["image"], batch["mask"] = images, masks
            yield batch


class DeviceLoader:
    """Iterates batches on ``device`` with a background host prefetch.

    order        explicit index order of the epoch (shuffling is the
                 caller's policy).
    transform    batch function on the card, called as
                 ``transform(images, masks[, generator])`` with a generator
                 from ``rng_stream`` when one is given.
    drop_last    leave out the epoch's final partial batch (the MAE train
                 loader, JAX ``cli/train_ae.py:77``).

    On a CUDA device the producer thread pins each host batch (a fresh
    pinned buffer a batch, which the caching host allocator keeps until the
    copy that reads it has ended), copies it with ``non_blocking=True`` on
    a side stream and records an event; the consumer's stream waits on that
    event, and each tensor is recorded on the consumer's stream so its
    memory is not reused while the consumer's kernels may still read it.
    A producer error is raised in the consumer.
    """

    def __init__(self, records: DermRecords, batch_size: int,
                 order: Optional[np.ndarray] = None,
                 transform: Optional[Callable] = None,
                 rng_stream=None,
                 device: Device = "cuda", drop_last: bool = False):
        self.records = records
        self.batch_size = batch_size
        self.order = (np.arange(len(records)) if order is None
                      else np.asarray(order))
        self.transform = transform
        self.rng_stream = rng_stream
        self.device = torch.device(device)
        self.drop_last = drop_last

    def _n_rows(self) -> int:
        """The rows of the epoch's batches (less the partial one under
        ``drop_last``)."""
        n = len(self.order)
        return n - n % self.batch_size if self.drop_last else n

    def __len__(self):
        return -(-self._n_rows() // self.batch_size)

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        records = self.records
        native_batch = records.use_native and records.with_image
        for start in range(0, self._n_rows(), self.batch_size):
            idx = [int(i) for i in self.order[start:start + self.batch_size]]
            if not native_batch:
                yield _collate([records[i] for i in idx])
                continue
            # metadata without decode + one threaded C call for the batch
            batch = _collate([records.metadata(i) for i in idx])
            cache = records._cache
            todo = idx if cache is None else [i for i in idx
                                              if i not in cache]
            if todo:
                rows = records.df.iloc[todo]
                images, masks = native_io.decode_crop_batch(
                    rows["image_path"].tolist(),
                    [str(p) for p in rows["segmentation_path"]],
                    records.staging_hw)
                if cache is not None:
                    for pos, i in enumerate(todo):
                        cache[i] = (images[pos], masks[pos])
            if cache is not None:
                batch["image"] = np.stack([cache[i][0] for i in idx])
                batch["mask"] = np.stack([cache[i][1] for i in idx])
            else:
                batch["image"], batch["mask"] = images, masks
            yield batch

    def _to_device(self, host: Dict[str, np.ndarray], stream
                   ) -> Tuple[Dict[str, torch.Tensor], object]:
        """Host batch → (tensors on the device, the copy's event or None).
        Runs on the producer thread."""
        if stream is None:  # the CPU
            return {k: _tensor(v) for k, v in host.items()}, None
        with torch.cuda.stream(stream):
            out = {k: _tensor(v).pin_memory().to(self.device,
                                                 non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        sentinel = object()
        error_box = []
        stop = threading.Event()
        stream = (torch.cuda.Stream(device=self.device)
                  if self.device.type == "cuda" else None)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for host in self._host_batches():
                    if not put(self._to_device(host, stream)):
                        return
            except BaseException as e:  # surfaced in the consumer
                error_box.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error_box:
                        raise error_box[0]
                    return
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for t in batch.values():
                        t.record_stream(current)
                if "image" in batch:
                    images, masks = batch.pop("image"), batch.pop("mask")
                    if self.transform is not None:
                        if self.rng_stream is not None:
                            images, masks = self.transform(
                                images, masks, self.rng_stream.next())
                        else:
                            images, masks = self.transform(images, masks)
                    batch["image"], batch["mask"] = images, masks
                yield batch
        finally:  # a consumer that stops early releases the producer
            stop.set()
            thread.join(timeout=60)
