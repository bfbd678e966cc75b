"""Interactive viewer controller: the port's copy of
`dexrobot_isaac_tpu/graphics/viewer.py`.

Camera view modes, env selection and the keyboard set (ENTER cycles the
view mode, F toggles follow, UP/DOWN select the env, E resets the selected
env, SPACE toggles random actions, C toggles the contact tint). Frames go
to the MJPEG streamer when there is one, else to a matplotlib window
(where the host has no display, that logs at debug level and shows
nothing). Keys come from the window, or from the browser through the
streamer's `/control?key=`: `push_key` queues them thread-safely and
`render` drains the queue on the render thread, so the E key's reset runs
there and never on an HTTP worker thread.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

import numpy as np

from dexrobot_isaac_tpu_torch.graphics.renderer import EnvRows, SceneRenderer, env_rows
from dexrobot_isaac_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

VIEW_MODES = ("overview", "follow", "side", "top")


class ViewerController:
    def __init__(
        self,
        renderer: SceneRenderer,
        num_envs: int,
        on_reset_env: Optional[Callable[[int], None]] = None,
        on_toggle_random_actions: Optional[Callable[[], None]] = None,
        streamer=None,
        box2_size: Optional[float] = None,
    ):
        self.renderer = renderer
        self.num_envs = num_envs
        self.box2_size = box2_size
        self.on_reset_env = on_reset_env
        self.on_toggle_random_actions = on_toggle_random_actions
        self.streamer = streamer
        self.selected_env = 0
        self.view_mode_idx = 0
        self.follow = False
        self.show_contacts = True
        self._fig = None
        self._im = None
        self._pending: deque = deque(maxlen=32)
        self._pending_lock = threading.Lock()
        if streamer is not None and hasattr(streamer, "on_key"):
            streamer.on_key = self.push_key

    # ------------------------------------------------------------------
    # keyboard semantics (viewer_controller.py:185-350)
    # ------------------------------------------------------------------
    _BROWSER_KEYS = {
        "enter": "enter", "arrowup": "up", "arrowdown": "down",
        " ": " ", "spacebar": " ", "space": " ",
    }

    def push_key(self, key: str) -> None:
        """Thread-safe key enqueue (called from the streamer's HTTP worker
        threads). Accepts browser KeyboardEvent.key names ("Enter",
        "ArrowUp", " ", "e") and the internal names; `render` drains."""
        k = self._BROWSER_KEYS.get(key.lower(), key.lower())
        with self._pending_lock:
            self._pending.append(k)

    def drain_keys(self) -> None:
        """Apply queued browser keys on the caller's (render) thread."""
        while True:
            with self._pending_lock:
                if not self._pending:
                    return
                k = self._pending.popleft()
            self.handle_key(k)

    def handle_key(self, key: str) -> None:
        if key == "enter":
            self.view_mode_idx = (self.view_mode_idx + 1) % len(VIEW_MODES)
            logger.info(f"View mode: {VIEW_MODES[self.view_mode_idx]}")
        elif key == "f":
            self.follow = not self.follow
            logger.info(f"Camera follow: {self.follow}")
        elif key == "up":
            self.selected_env = (self.selected_env + 1) % self.num_envs
            logger.info(f"Selected env: {self.selected_env}")
        elif key == "down":
            self.selected_env = (self.selected_env - 1) % self.num_envs
            logger.info(f"Selected env: {self.selected_env}")
        elif key == "e" and self.on_reset_env:
            self.on_reset_env(self.selected_env)
        elif key == " " and self.on_toggle_random_actions:
            self.on_toggle_random_actions()
        elif key == "c":
            self.show_contacts = not self.show_contacts
            logger.info(f"Contact visualization: {self.show_contacts}")

    def _apply_view(self, hand_pos: np.ndarray) -> None:
        mode = VIEW_MODES[self.view_mode_idx]
        r = self.renderer
        if mode == "side":
            r.camera_pos = np.array([0.05, -0.9, 0.25])
        elif mode == "top":
            r.camera_pos = np.array([0.05, 0.0, 1.2])
        else:
            r.camera_pos = np.array([0.7, -0.7, 0.55])
        if self.follow or mode == "follow":
            r.camera_target = hand_pos
        else:
            r.camera_target = np.array([0.05, 0.0, 0.15])

    # ------------------------------------------------------------------
    def render(self, kin, physics, body_contact_force=None, has_box=True):
        """Render the selected env; display in window or stream. `kin`,
        `physics` and `body_contact_force` hold every env (numpy arrays or
        tensors); `render_env` computes the selected env's FK alone."""
        self.drain_keys()
        e = self.selected_env
        return self._show(EnvRows.select(kin, physics, body_contact_force, e), e, has_box)

    def render_env(self, engine, physics, spawn, body_contact_force=None, has_box=True):
        """`render` from the env state on its device: the FK of the
        selected env alone and one host copy of its rows
        (renderer.env_rows)."""
        self.drain_keys()
        e = self.selected_env
        return self._show(env_rows(engine, physics, spawn, body_contact_force, e), e, has_box)

    def _show(self, rows: EnvRows, e: int, has_box: bool) -> np.ndarray:
        self._apply_view(np.asarray(rows.body_pos[5]))
        frame = rows.render(self.renderer, f"env {e} | {VIEW_MODES[self.view_mode_idx]}",
                            has_box=has_box, contacts=self.show_contacts,
                            box2_size=self.box2_size)
        if self.streamer is not None:
            self.streamer.add_frame(frame)
        else:
            self._show_window(frame)
        return frame

    def _show_window(self, frame: np.ndarray) -> None:
        try:
            import matplotlib.pyplot as plt

            if self._fig is None:
                plt.ion()
                self._fig, ax = plt.subplots()
                ax.axis("off")
                self._im = ax.imshow(frame)
                self._fig.canvas.mpl_connect(
                    "key_press_event", lambda ev: self.handle_key(ev.key or "")
                )
            else:
                self._im.set_data(frame)
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
        except Exception as e:  # headless host without display
            logger.debug(f"Viewer window unavailable ({e}); use videoStream")

    def close(self) -> None:
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
            self._fig = None
