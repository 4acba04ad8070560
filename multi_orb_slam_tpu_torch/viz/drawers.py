"""Headless visualization: frame and map drawers.

Counterpart of `multi_orb_slam_tpu/viz/drawers.py` (which replaces the
reference's Pangolin / OpenCV stack, src/FrameDrawer.cc, src/MapDrawer.cc,
src/Viewer.cc, with images written to disk):

- `draw_frame`: the image with its keypoints (green matched, blue not) and
  the status bar text (state, keyframes, map points, matches; reference
  FrameDrawer.cc:42-243)
- `draw_map`: map points, keyframe centres with a viewing-direction tick,
  covisibility edges and the current camera, seen from above (x-z; reference
  MapDrawer.cc:44-220)
- `Viewer`: writes frame and map snapshots every `every` frames

The drawers read the port's `Tracker` / `MapState` tensors through `.cpu()`,
so they work on a tracker on any device.  `cv2` and `matplotlib` are imported
only when a drawing is made; neither is needed to track.
"""

from __future__ import annotations

import os

import numpy as np

from ..mapping import map_state as ms


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def draw_frame(gray: np.ndarray, xy: np.ndarray, matched_mask: np.ndarray,
               state_text: str = "") -> np.ndarray:
    """Annotated BGR image: green squares on matched keypoints, blue on
    unmatched (reference FrameDrawer::DrawFrame)."""
    import cv2

    img = cv2.cvtColor(np.asarray(gray).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    for (x, y), m in zip(np.asarray(xy), np.asarray(matched_mask)):
        p = (int(round(float(x))), int(round(float(y))))
        color = (0, 255, 0) if m else (255, 0, 0)
        cv2.rectangle(img, (p[0] - 3, p[1] - 3), (p[0] + 3, p[1] + 3), color, 1)
        cv2.circle(img, p, 1, color, -1)
    if state_text:
        bar = np.zeros((22, img.shape[1], 3), np.uint8)
        cv2.putText(bar, state_text, (5, 15), cv2.FONT_HERSHEY_PLAIN, 1,
                    (255, 255, 255), 1)
        img = np.concatenate([img, bar], axis=0)
    return img


def frame_status_text(tracker) -> str:
    """Reference FrameDrawer status line (FrameDrawer.cc:168-204)."""
    state = tracker.state
    if state == 0:
        return "WAITING FOR IMAGES / NOT INITIALIZED"
    if state == 2:
        return "TRACK LOST. TRYING TO RELOCALIZE"
    mode = "LOCALIZATION | " if tracker.only_tracking else "SLAM MODE | "
    return (f"{mode}KFs: {int(tracker.map.n_kf)}, MPs: {int(tracker.map.n_mp)}, "
            f"Matches: {tracker.last_n_inliers}")


def draw_map(state: ms.MapState, current_Tcw=None, local_mp_mask=None,
             out_path: str | None = None, show_covisibility: bool = True):
    """Top-down (x-z) map rendering (MapDrawer::DrawMapPoints /
    DrawKeyFrames).  Returns the matplotlib figure; saves it to `out_path`
    if given (and closes it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    mp = _host(state.mp_pos)
    mv = _host(state.mp_valid)
    ax.scatter(mp[mv, 0], mp[mv, 2], s=1, c="k", alpha=0.4,
               label=f"map points ({int(mv.sum())})")
    if local_mp_mask is not None:
        lm = _host(local_mp_mask) & mv
        ax.scatter(mp[lm, 0], mp[lm, 2], s=2, c="r", label="local points")

    kf_valid = _host(state.kf_valid)
    kf_Tcw = _host(state.kf_Tcw)
    centers = {}
    for k in np.nonzero(kf_valid)[0]:
        T = kf_Tcw[k]
        c = -T[:3, :3].T @ T[:3, 3]
        centers[int(k)] = c
        fwd = T[:3, :3].T @ np.array([0.0, 0.0, 0.2])     # viewing direction tick
        ax.plot([c[0], c[0] + fwd[0]], [c[2], c[2] + fwd[2]], "b-", lw=0.8)
    if centers:
        cs = np.stack(list(centers.values()))
        ax.scatter(cs[:, 0], cs[:, 2], s=14, c="b", marker="s",
                   label=f"keyframes ({len(centers)})")

    if show_covisibility and len(centers) > 1:
        W = _host(ms.covisibility(state))
        for a, ca in centers.items():
            for b, cb in centers.items():
                if a < b and W[a, b] >= 15:
                    ax.plot([ca[0], cb[0]], [ca[2], cb[2]], "g-", lw=0.4, alpha=0.5)

    if current_Tcw is not None:
        T = _host(current_Tcw)
        c = -T[:3, :3].T @ T[:3, 3]
        ax.scatter([c[0]], [c[2]], s=60, c="lime", marker="^", label="current camera")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


class Viewer:
    """Periodic snapshot writer standing in for the Pangolin UI thread
    (reference src/Viewer.cc:54-140).  Call `update` once per frame; every
    `every` frames it writes `frame_<n>.png` (camera 0 with its keypoints)
    and `map_<n>.png` to `out_dir`."""

    def __init__(self, out_dir: str, every: int = 30):
        self.out_dir = out_dir
        self.every = every
        self.count = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, tracker, gray: np.ndarray | None = None):
        self.count += 1
        if self.count % self.every:
            return
        tag = f"{self.count:06d}"
        if gray is not None and tracker.prev_mp is not None:
            import cv2

            xy = _host(tracker.prev_frame.xy[0])
            ok = _host(tracker.prev_mp[0]) >= 0
            img = draw_frame(_host(gray), xy, ok, frame_status_text(tracker))
            cv2.imwrite(os.path.join(self.out_dir, f"frame_{tag}.png"), img)
        draw_map(tracker.map, tracker.Tcw,
                 out_path=os.path.join(self.out_dir, f"map_{tag}.png"))
