"""A dataset staged on the card once, for device-resident epochs.

Counterpart of ``multimodal_isic_tpu/data/pipeline.py::DeviceDataset``
(:148-221).  It is built from in-memory uint8 crops [N, H, W, 3] (the
450² staging crops) and a metadata dict of per-row columns (``radiomics``,
``age``, ``sex``, ``loc``, ``artifacts``, ``target``), because reading
records from disk (``DermRecords``, cv2 and pandas) comes with the host-data
port.  Everything is copied to the device once; each epoch then gathers and
augments its batches on the device.  Integer columns become int64, the index
type of ``nn.Embedding`` and ``F.cross_entropy``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch


class DeviceDataset:
    def __init__(self, images: np.ndarray, meta: Dict[str, np.ndarray],
                 masks: Optional[np.ndarray] = None,
                 device: Union[str, torch.device] = "cuda",
                 with_masks: bool = True):
        """``with_masks=False`` stages no masks: the fusion train step never
        reads them, so the fast policy (which passes masks through) needs
        none.  Mask-consuming transforms need ``with_masks=True`` and
        ``masks`` [N, H, W]."""
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
        self.meta = {k: self._column(v) for k, v in meta.items()}

    def _column(self, v: np.ndarray) -> torch.Tensor:
        v = np.ascontiguousarray(v)
        if np.issubdtype(v.dtype, np.integer):
            v = v.astype(np.int64)
        return torch.from_numpy(v).to(self.device)

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
