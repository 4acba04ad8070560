"""The port's headless viewer (`viz/drawers.py`), on the CPU: the port's
copy of `tests/test_native_viz.py::TestViz`.  The drawers need cv2 and
matplotlib, which the CUDA machine does not have, so viz is held here only.
"""

import os

import numpy as np
import torch

from multi_orb_slam_tpu_torch.config import SlamConfig
from multi_orb_slam_tpu_torch.frontend import tracking
from multi_orb_slam_tpu_torch.geometry import camera as cam_mod
from multi_orb_slam_tpu_torch.io import synthetic
from multi_orb_slam_tpu_torch.ops import orb
from multi_orb_slam_tpu_torch.viz import drawers

torch.set_num_threads(2)


def test_draw_frame_and_map(tmp_path):
    cfg = SlamConfig(n_cams=1, max_feat=512, max_kf=32, max_mp=8192, local_cap=1024,
                     new_mp_per_cam=128, width=320, height=240, th_depth=6.0,
                     orb=orb.ORBConfig(n_features=512))
    calib = cam_mod.CameraParams(
        K=torch.tensor([[260.0, 260.0, 160.0, 120.0]]), dist=torch.zeros((1, 5)),
        T_rc=torch.eye(4)[None], bf=torch.tensor(20.0), width=320, height=240)
    seq = synthetic.make_sequence(n_frames=4, K=np.array([260.0, 260.0, 160.0, 120.0]),
                                  height=240, width=320, n_points=2500)
    tr = tracking.Tracker(calib, cfg, device="cpu")
    assert drawers.frame_status_text(tr) == "WAITING FOR IMAGES / NOT INITIALIZED"
    viewer = drawers.Viewer(str(tmp_path / "viz"), every=2)
    for g, d in zip(seq.grays, seq.depths):
        tr.process(g, d)
        viewer.update(tr, g[0])
    outs = sorted(os.listdir(str(tmp_path / "viz")))
    assert outs == ["frame_000002.png", "frame_000004.png", "map_000002.png", "map_000004.png"]
    # as in the reference's test, the 4-frame orbit may have lost the track
    # by its last frame (its steps are large)
    txt = drawers.frame_status_text(tr)
    if tr.state == 2:
        assert txt == "TRACK LOST. TRYING TO RELOCALIZE"
    else:
        assert txt.startswith("SLAM MODE | KFs: ") and "Matches: " in txt
    img = drawers.draw_frame(seq.grays[0][0], tr.prev_frame.xy[0].numpy(),
                             (tr.prev_mp[0] >= 0).numpy(), txt)
    assert img.shape == (240 + 22, 320, 3) and img.dtype == np.uint8
    tr.state, tr.only_tracking = 1, True
    assert drawers.frame_status_text(tr).startswith("LOCALIZATION | KFs: ")
