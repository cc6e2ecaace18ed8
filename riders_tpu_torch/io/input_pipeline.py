"""Host input pipeline: dataset loading, augmentation, batching, prefetch.

* ``SMLFrameDataset`` - the per-frame sextuple of stage 3 (image, mono
  prior, radar, interpolated and sparse lidar GT, stage-2 depth) with
  its training augmentations: crop then resize back, horizontal flip,
  radar depth noise, a random stage-2 threshold, the fall-back of an
  all-zero stage-2 map to the raw radar, and the HSV photometric hooks.
* ``RCNetTrainDataset`` - the patch-training samples of stage 2: the
  edge-padded frame with photometric augmentation, a fixed number of
  radar points (sparse frames repeated x100 first), pseudo-radar from
  the lidar GT, horizontal and vertical flips, per-point boxes and GT
  crops, and noise on the points fed to the point encoder.
* ``RCNetInferenceDataset`` - the edge-padded frame and the fixed-size
  point bucket of stage 2.
* ``BatchLoader`` - a prefetching batcher: threads (or, with
  `num_workers`, spawned processes) decode samples, a producer thread
  stacks them and, with `device_put`, copies them through pinned host
  memory to the loader's device.

Every sample draws its randomness from a private numpy stream seeded by
(seed, epoch, index), so batches do not depend on the number or order of
workers, and are byte-identical to the JAX package's loaders.  cv2 is
imported only by the augmentations that use it.
"""

from __future__ import annotations

import queue
import threading
from contextlib import nullcontext
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.core.device import resolve_device, to_device
from riders_tpu_torch.io import depthio
from riders_tpu_torch.io.manifest import FrameRecord, swap_rcnet_threshold
from riders_tpu_torch.pipelines.rcnet_inference import pad_image_for_patches


def _normalize_range(image01: np.ndarray, rng) -> np.ndarray:
    """Map a [0, 1] image to the configured intensity range ([0, 1],
    [-1, 1] or [0, 255])."""
    lo, hi = rng
    if (lo, hi) == (0.0, 1.0):
        return image01
    return (image01 * (hi - lo) + lo).astype(np.float32)


def _crop_resize_back(arrays: List[np.ndarray], shape, rng
                      ) -> List[np.ndarray]:
    """Crop every array at one random window of `shape` (horizontal start
    uniform; vertical centred, or uniform with probability 0.3) and
    resize it back to its size."""
    import cv2
    n_h, n_w = shape
    o_h, o_w = arrays[0].shape[:2]
    d_h, d_w = o_h - n_h, o_w - n_w
    x_start = rng.integers(0, max(d_w, 1))
    y_start = d_h // 2
    if rng.random() <= 0.30 and d_h > 0:
        y_start = rng.integers(0, d_h)
    return [cv2.resize(a[y_start:y_start + n_h, x_start:x_start + n_w],
                       (o_w, o_h)) for a in arrays]


def _hsv_adjust(image: np.ndarray, rng, brightness=None, contrast=None,
                saturation=None) -> np.ndarray:
    """HSV photometric augmentation; each given range applies with
    probability 0.5 (with none given the image passes through)."""
    import cv2
    img = image
    for channel, factor in ((2, brightness), (1, contrast),
                            (1, saturation)):
        if factor is not None and rng.random() < 0.5:
            hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
            hsv[:, :, channel] = hsv[:, :, channel] * rng.uniform(*factor)
            img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return img


def _sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch,
                                                         index]))


class SMLFrameDataset:
    """Per-frame loader of stages 1 and 3."""

    def __init__(self, cfg: RidersConfig, records: Sequence[FrameRecord],
                 train: bool = False, seed: int = 0):
        self.cfg = cfg
        self.records = list(records)
        self.train = train
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.records)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        t = cfg.sml_train
        rec = self.records[index]
        rng = _sample_rng(self.seed, self._epoch, index)

        image = depthio.read_image_unit(rec.image)
        mono_pred = depthio.load_depth(rec.mono_pred)
        if rec.radar and rec.radar.endswith(".npy"):
            pts = depthio.load_radar_points(rec.radar)
            radar = depthio.scatter_points_to_map(pts, mono_pred.shape)
        else:
            radar = depthio.load_depth(rec.radar)
        # The alignment solve gathers the valid radar pixels into a
        # bucket of alignment.max_valid_pixels; a denser map would be cut
        # there, so refuse it here.
        bound = cfg.alignment.max_valid_pixels
        if bound is not None and np.count_nonzero(radar) > bound:
            raise ValueError(
                f"radar map {rec.radar!r} has {np.count_nonzero(radar)} "
                f"nonzero pixels > alignment.max_valid_pixels={bound}; "
                "set alignment.max_valid_pixels=None (dense objective) "
                "for dense alignment targets")
        gt_interp = depthio.load_depth(rec.gt_interp)
        gt_sparse = depthio.load_depth(rec.gt_sparse)

        if rec.rcnet is not None:
            rcnet_path = rec.rcnet
            if self.train and t.random_rcnet_thresholds:
                thr = rng.choice(list(t.random_rcnet_thresholds))
                rcnet_path = swap_rcnet_threshold(rec, float(thr))
            rcnet = depthio.load_depth(rcnet_path)
            if rcnet.sum() == 0:        # an empty stage-2 map: raw radar
                rcnet = radar.copy()
        else:
            rcnet = radar.copy()

        maps = [image, mono_pred, radar, gt_interp, gt_sparse, rcnet]
        if self.train:
            if t.random_crop_size is not None and rng.random() > 0.2:
                maps = _crop_resize_back(maps, t.random_crop_size, rng)
            if t.random_flip and rng.random() > 0.5:
                maps = [np.ascontiguousarray(m[:, ::-1]) for m in maps]
            if t.random_radar_noise is not None and rng.random() > 0.5:
                lo, hi = t.random_radar_noise
                radar = maps[2].copy()
                valid = radar > 0
                radar[valid] += rng.normal(
                    lo, hi, int(valid.sum())).astype(np.float32)
                maps[2] = radar
            maps[0] = _hsv_adjust(maps[0].astype(np.float32), rng)

        keys = ("image", "mono_pred", "radar", "gt_interp", "gt_sparse",
                "rcnet")
        return {k: m.astype(np.float32) for k, m in zip(keys, maps)}


class RCNetTrainDataset:
    """Per-frame samples of RC-Net training.  Each sample draws, from its
    (seed, epoch, index) stream and in this order: the three photometric
    coins and factors, the point sample, the pseudo-radar branch, the two
    flips and the point noise."""

    def __init__(self, cfg: RidersConfig, records: Sequence[FrameRecord],
                 seed: int = 0):
        self.cfg = cfg
        self.records = list(records)
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.records)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _photometric(self, image01: np.ndarray, rng) -> np.ndarray:
        """Brightness, contrast (about the image mean) and saturation
        (about the luma), each with probability 0.5 x
        augmentation_probability and a uniform factor, clipped to
        [0, 1]."""
        t = self.cfg.rcnet_train
        img = image01
        if rng.random() < 0.5 * t.augmentation_probability:
            img = np.clip(img * rng.uniform(*t.random_brightness),
                          0.0, 1.0)
        if rng.random() < 0.5 * t.augmentation_probability:
            mean = img.mean()
            img = np.clip((img - mean) * rng.uniform(*t.random_contrast)
                          + mean, 0.0, 1.0)
        if rng.random() < 0.5 * t.augmentation_probability:
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])[..., None]
            img = np.clip(gray + (img - gray)
                          * rng.uniform(*t.random_saturation), 0.0, 1.0)
        return img.astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        t = cfg.rcnet_train
        K = t.points_per_frame
        ph, pw = cfg.rcnet.patch_size
        pad_y, pad_x = ph // 2, pw // 2
        rec = self.records[index]
        rng = _sample_rng(self.seed, self._epoch, index)

        image = depthio.load_image(rec.image, normalize=True)
        image = np.pad(image, ((pad_y, pad_y), (pad_x, pad_x), (0, 0)),
                       mode="edge")
        image = self._photometric(image, rng)
        image = _normalize_range(image, cfg.rcnet.normalized_image_range)

        points = depthio.load_radar_points(rec.radar)
        if points.shape[0] <= K:
            points = np.repeat(points, 100, axis=0)
        points = points[rng.integers(0, points.shape[0], K)].astype(
            np.float32)

        gt = depthio.load_depth(rec.gt_interp)
        # Pseudo-radar from the lidar GT: x jittered, depth pushed back
        # by up to 0.5 m; y stays the radar point's, as in the reference.
        if rng.random() < t.sample_probability_of_lidar:
            ly, lx = np.where(gt > 1)
            if len(ly) >= K:
                pick = rng.choice(len(ly), K, replace=False)
                px = lx[pick] + rng.normal(0, 25, K)
                px = np.clip(px, 0, gt.shape[1]).astype(np.int64)
                pz = gt[ly[pick], lx[pick]] + rng.uniform(0.0, 0.5, K)
                points = np.stack([px.astype(np.float32), points[:, 1],
                                   pz.astype(np.float32)], axis=1)

        H_img, W_img = gt.shape
        if ("horizontal" in t.random_flip_type
                and rng.random() < 0.5 * t.augmentation_probability):
            image = np.ascontiguousarray(image[:, ::-1])
            gt = np.ascontiguousarray(gt[:, ::-1])
            points[:, 0] = W_img - 1 - points[:, 0]
        if ("vertical" in t.random_flip_type
                and rng.random() < 0.5 * t.augmentation_probability):
            image = np.ascontiguousarray(image[::-1])
            gt = np.ascontiguousarray(gt[::-1])
            points[:, 1] = H_img - 1 - points[:, 1]

        # to padded coordinates; a box is the patch around its point
        points[:, 0] += pad_x
        points[:, 1] += pad_y
        boxes = np.stack([points[:, 0] - pad_x, points[:, 1] - pad_y,
                          points[:, 0] + pad_x, points[:, 1] + pad_y],
                         axis=1).astype(np.float32)
        # A pseudo-radar x is clipped to [0, W], so a horizontal flip can
        # put a point at x = -1, a patch one pixel left of the padded
        # frame: one more zero row and column on the top and left give
        # that patch its crop (the JAX package's loader raises there).
        gt_pad = np.pad(gt, ((pad_y + 1, pad_y), (pad_x + 1, pad_x)),
                        mode="constant")
        crops = np.zeros((K, ph, pw, 1), np.float32)
        for i in range(K):
            y0 = int(points[i, 1]) - pad_y + 1
            x0 = int(points[i, 0]) - pad_x + 1
            crops[i, :, :, 0] = gt_pad[y0:y0 + ph, x0:x0 + pw]

        # noise on the points the point encoder sees; boxes keep theirs
        if (t.random_noise_type != "none" and t.random_noise_spread > 0
                and rng.random() < 0.5 * t.augmentation_probability):
            if t.random_noise_type == "gaussian":
                noise = rng.standard_normal(points.shape).astype(np.float32)
            elif t.random_noise_type == "uniform":
                noise = rng.random(points.shape).astype(np.float32) - 0.5
            else:
                raise ValueError(
                    f"unsupported noise type: {t.random_noise_type}")
            points = (points + t.random_noise_spread * noise).astype(
                np.float32)

        return {"image": image, "points": points, "boxes": boxes,
                "gt_crops": crops,
                "point_mask": np.ones(K, np.float32)}


class RCNetInferenceDataset:
    """Per-frame loader of stage-2 inference: the edge-padded frame in the
    configured range and the fixed-K point bucket with its mask."""

    def __init__(self, cfg: RidersConfig, records: Sequence[FrameRecord]):
        self.cfg = cfg
        self.records = list(records)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rec = self.records[index]
        image = depthio.load_image(rec.image, normalize=True)
        image = _normalize_range(image, cfg.rcnet.normalized_image_range)
        image = pad_image_for_patches(image, cfg.rcnet.patch_size)
        points = depthio.load_radar_points(rec.radar)
        pts, mask = depthio.pad_points(points, cfg.dataset.max_points)
        return {"image": image.astype(np.float32), "points": pts,
                "point_mask": mask}


def _stack(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# The dataset of a decode process, set once by the pool's initializer
# (a task carries only its (epoch, index)); worker processes look these
# functions up by their qualified names.
_POOL_DATASET = None


def _pool_init(dataset) -> None:
    global _POOL_DATASET
    _POOL_DATASET = dataset


def _pool_get(args):
    epoch, index = args
    if hasattr(_POOL_DATASET, "set_epoch"):
        _POOL_DATASET.set_epoch(epoch)
    return _POOL_DATASET[index]


class BatchLoader:
    """Prefetching batcher.

    Samples decode on `num_threads` threads, or, with `num_workers` > 0,
    in a pool of processes started with `mp_context` ("spawn" by
    default: a forked child of a process that has initialised CUDA or
    started threads is unsafe).  The dataset goes to each process once
    and must pickle.  A producer thread stacks `prefetch` batches ahead.
    With `device_put` a batch holds tensors on `device` (the card unless
    device='cpu'), else numpy arrays.  `close()` stops the processes.
    With `rows`, only those rows of each batch are decoded and yielded
    (a data-parallel rank's share); the order of the batches is the
    whole batches' own.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_threads: int = 4, prefetch: int = 2, seed: int = 0,
                 drop_last: bool = True, device_put: bool = True,
                 device=None, num_workers: int = 0,
                 mp_context: str = "spawn", rows: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.device = resolve_device(device) if device_put else None
        self.num_workers = num_workers
        self.mp_context = mp_context
        self.rows = rows
        self._epoch_count = 0
        self._pool = None

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            self._pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context(self.mp_context),
                initializer=_pool_init, initargs=(self.dataset,))
        return self._pool

    def close(self) -> None:
        """Shut the decode processes down (nothing to do for threads)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def epoch(self) -> Iterator[Dict]:
        """The batches of one epoch, in order.  Each epoch advances the
        dataset's augmentation streams and, with `shuffle`, reorders."""
        epoch = self._epoch_count
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        self._epoch_count += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.rows is not None:
            batches = [b[self.rows] for b in batches]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: List[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if self.num_workers > 0:
                    pool = self._process_pool()
                    run = nullcontext(pool)
                    fetch = lambda idxs: list(pool.map(
                        _pool_get, [(epoch, int(i)) for i in idxs]))
                else:
                    from concurrent.futures import ThreadPoolExecutor
                    pool = run = ThreadPoolExecutor(self.num_threads)
                    fetch = lambda idxs: list(pool.map(
                        self.dataset.__getitem__, idxs))
                with run:
                    for idxs in batches:
                        batch = _stack(fetch(idxs))
                        if self.device is not None:
                            batch = {k: to_device(v, self.device, True)
                                     for k, v in batch.items()}
                        if not put(batch):
                            return
            except BaseException as e:      # handed to the consumer
                failure.append(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
            if failure:
                raise failure[0]
        finally:
            stop.set()
            thread.join(timeout=60.0)
