"""Per-episode MP4 recording with a writer thread: the port's copy of
`dexrobot_isaac_tpu/graphics/video.py`.

One file per episode, the FPS from the control rate (`finalize_fps`), a new
file when `max_duration_seconds` is reached, and encoding on a background
thread (OpenCV's `mp4v` writer, imported there) so that a frame never
blocks stepping: when the queue of 256 frames is full, frames are dropped.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np

from dexrobot_isaac_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class VideoRecorder:
    def __init__(
        self,
        output_dir: str,
        fps: Optional[float] = None,
        max_duration_seconds: float = 60.0,
        filename_prefix: str = "episode",
    ):
        self.output_dir = output_dir
        self.fps = fps
        self.max_frames = None
        self.max_duration = max_duration_seconds
        self.prefix = filename_prefix
        self._queue: "queue.Queue" = queue.Queue(maxsize=256)
        self._thread: Optional[threading.Thread] = None
        self._writer = None
        self._episode = 0
        self._frames_in_file = 0
        os.makedirs(output_dir, exist_ok=True)

    def finalize_fps(self, control_dt: float) -> None:
        """Set FPS from the control rate (video_recorder.py:104-128)."""
        if self.fps is None:
            self.fps = 1.0 / control_dt
        self.max_frames = int(self.max_duration * self.fps)

    def start_episode(self) -> None:
        self.stop_episode()
        self._episode += 1
        self._frames_in_file = 0
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def add_frame(self, frame: np.ndarray) -> None:
        """Queue an RGB uint8 frame; drops frames if the encoder lags."""
        try:
            self._queue.put_nowait(("frame", frame, self._episode))
        except queue.Full:
            pass  # drop rather than stall the sim loop

    def stop_episode(self) -> None:
        if self._thread is not None:
            self._queue.put(("close", None, self._episode))

    def close(self) -> None:
        if self._thread is not None:
            self._queue.put(("stop", None, None))
            self._thread.join(timeout=10)
            self._thread = None

    # ------------------------------------------------------------------
    def _worker(self) -> None:
        import cv2

        writer = None
        current_ep = None
        while True:
            kind, frame, ep = self._queue.get()
            if kind == "stop":
                break
            if kind == "close":
                if writer is not None:
                    writer.release()
                    writer = None
                continue
            if writer is None or ep != current_ep or (
                self.max_frames and self._frames_in_file >= self.max_frames
            ):
                if writer is not None:
                    writer.release()
                current_ep = ep
                self._frames_in_file = 0
                path = os.path.join(
                    self.output_dir, f"{self.prefix}_{ep:05d}.mp4"
                )
                h, w = frame.shape[:2]
                writer = cv2.VideoWriter(
                    path, cv2.VideoWriter_fourcc(*"mp4v"),
                    self.fps or 25.0, (w, h),
                )
                logger.info(f"Recording video: {path}")
            writer.write(frame[..., ::-1])  # RGB -> BGR
            self._frames_in_file += 1
        if writer is not None:
            writer.release()
