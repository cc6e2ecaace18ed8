"""Serving loop of the fused pipeline, and its on-disk frame loader.

`FusedServer` overlaps the three phases of serving:

    host decode / batch  ->  upload to the card  ->  fused compute

An uploader thread pins each host batch and copies it to the card on a
side CUDA stream; the compute stream waits for that copy's event before
the fused call, so the copy of batch i+1 runs while batch i computes.
Each result is copied back into pinned host memory right behind its own
call, and an event marks that copy's end: handing result i back waits
for batch i alone, not for the calls queued after it.  Up to `depth`
results stay in flight, and they are handed back as numpy arrays in
order.

Each phase is a span (`core.tracing`) under the batch's sequence number
in the run: `server.upload` on the uploader thread; `server.wait_upload`
(blocked on the next upload), the fused call's `fused.*` spans,
`server.download` and `server.wait_result` (blocked on a result's copy)
on the caller's.
"""

from __future__ import annotations

import collections
import itertools
import os
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence

import numpy as np
import torch

from riders_tpu_torch.core import tracing
from riders_tpu_torch.core.device import resolve_device, to_device
from riders_tpu_torch.io import depthio


class FusedServer:
    """Pipelined executor over a fused function fn(batch) -> (B, H, W)
    depth (`pipelines.fused.make_fused_fn`, the weights bound in its
    modules) on `device` (the card unless device='cpu').

    `depth` batches are in flight at once (2 = double buffering).
    """

    def __init__(self, fused_fn: Callable, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.fused_fn = fused_fn
        self.depth = depth
        self.device = resolve_device(device)
        self.uploader: Optional[threading.Thread] = None

    def _upload(self, batch: Dict, stream) -> tuple:
        """(tensors on the device, the event that ends their copy)."""
        with tracing.span("server.upload"):
            if stream is None:
                return {k: to_device(v, self.device)
                        for k, v in batch.items()}, None
            with torch.cuda.stream(stream):
                staged = {k: to_device(v, self.device, pinned=True)
                          for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(stream)
            return staged, done

    def _download(self, out: torch.Tensor) -> tuple:
        """(host tensor, the event that ends its copy): on a card, a
        copy into pinned memory queued behind the call."""
        with tracing.span("server.download"):
            if self.device.type != "cuda":
                return out, None
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return host, done

    @staticmethod
    def _ready(item: tuple) -> np.ndarray:
        seq, host, done = item
        tracing.request(seq)
        with tracing.span("server.wait_result"):
            if done is not None:
                done.synchronize()
        return host.numpy()

    def run(self, batches: Iterable[Dict[str, np.ndarray]]
            ) -> Iterator[np.ndarray]:
        """Stream host batches through the card; yields depth maps as
        numpy arrays, in order.  The uploader thread is stopped and
        joined when the run ends, also when the caller abandons the
        generator early (its close() runs the finally block); an error
        in the uploader is raised here."""
        upload_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        failure: List[BaseException] = []
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def put(item) -> bool:
            # a put that gives up once the consumer has gone
            while not stop.is_set():
                try:
                    upload_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def uploader():
            try:
                for seq, batch in enumerate(batches):
                    tracing.request(seq)
                    if not put(self._upload(batch, copy_stream)):
                        return
            except BaseException as e:      # handed to the consumer
                failure.append(e)
            finally:
                put(None)

        thread = self.uploader = threading.Thread(target=uploader,
                                                  daemon=True)
        thread.start()
        try:
            in_flight: collections.deque = collections.deque()
            for seq in itertools.count():
                tracing.request(seq)
                with tracing.span("server.wait_upload"):
                    item = upload_q.get()
                if item is None:
                    break
                staged, done = item
                if done is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(done)
                    for t in staged.values():
                        t.record_stream(compute)
                in_flight.append((seq,
                                  *self._download(self.fused_fn(staged))))
                if len(in_flight) >= self.depth:
                    yield self._ready(in_flight.popleft())
            while in_flight:
                yield self._ready(in_flight.popleft())
            if failure:
                raise failure[0]
        finally:
            tracing.request(None)
            stop.set()
            thread.join(timeout=10.0)


class FusedInferenceDataset:
    """On-disk frames of the fused serving path.

    Each frame is `<name>_image.png` (RGB), `<name>_mono.png` (x256 PNG16
    inverse-depth prior) and `<name>_radar.npy` (n x 3 (u, v, depth)).
    Samples carry the batch keys `pipelines.fused.make_fused_fn` reads,
    so BatchLoader(FusedInferenceDataset(...), device_put=False) feeds
    FusedServer.

    `compact=True` stages the image as uint8 and the prior as its raw
    uint16 code (3.2x fewer bytes to upload; the fused function decodes
    them on the device).  A prior that overflows the 16-bit code (over
    255 m, a mode-'I' PNG) is staged as float32 instead, decided once
    for the whole dataset from the PNG headers: one batch never mixes
    codes with decoded values, which stacking would promote to float32
    and the device would then not decode.
    """

    def __init__(self, frame_dirs_or_names: Sequence[str], root: str = "",
                 max_points: int = 48, compact: bool = False):
        self.names = [os.path.join(root, n) for n in frame_dirs_or_names]
        self.max_points = max_points
        self.compact = compact
        self._mono_u16: Optional[bool] = None

    def _mono_is_uint16(self) -> bool:
        """True iff every mono PNG of the dataset holds a 16-bit code
        (a header-only probe, cached; loader threads that race compute
        the same answer)."""
        if self._mono_u16 is None:
            from PIL import Image
            ok = True
            for base in self.names:
                with Image.open(base + "_mono.png") as im:
                    if im.mode not in ("I;16", "I;16B", "I;16L"):
                        ok = False
                        break
            self._mono_u16 = ok
        return self._mono_u16

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        base = self.names[index]
        if self.compact:
            from PIL import Image
            image = np.asarray(
                Image.open(base + "_image.png").convert("RGB"), np.uint8)
            mono = np.asarray(Image.open(base + "_mono.png"))
            if self._mono_is_uint16():
                mono = mono.astype(np.uint16, copy=False)
            else:
                mono = (mono.astype(np.float32) / 256.0).clip(min=0)
        else:
            image = depthio.load_image(
                base + "_image.png", normalize=True).astype(np.float32)
            mono = depthio.load_depth(base + "_mono.png")
        points = depthio.load_radar_points(base + "_radar.npy")
        pts, mask = depthio.pad_points(points, self.max_points)
        return {"image": image, "mono_pred": mono,
                "radar_points": pts, "point_mask": mask}
