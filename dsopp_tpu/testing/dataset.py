"""A synthetic sequence written out as an application dataset.

The dataset is what ``python -m dsopp_tpu.app.main`` reads: ``.npy`` frames,
``times.txt``, a pinhole ``calib.txt``, ground-truth poses for the
precalculated initializer (``gt_init.tum``) and for evaluation
(``gt_full.tum``), and a JSON config.  The ``npy_folder`` provider, the
``precalculated`` initializer and a JSON config need neither OpenCV nor
PyYAML, so the whole path runs on a machine that has only JAX and NumPy.
"""

from __future__ import annotations

import json
import os

import numpy as np

# the reference's standart.yaml operating point (test_data/tummono)
STANDART_TRACKER = {
    "type": "monocular",
    "sensor_id": "camera_1",
    "number_of_desired_points": 2000,
    "keyframe_strategy": {"strategy": "mean_square_optical_flow",
                          "factor": 1.25},
    "marginalization_strategy": {"strategy": "sparse",
                                 "minimum_size": 5, "maximum_size": 8},
}


def write_dataset(root: str, seq, init_frames: int = 8,
                  tracker: dict = STANDART_TRACKER,
                  exposures=None) -> str:
    """Write ``seq`` (a :class:`SyntheticSequence`) under ``root``.

    ``exposures``: optional per-frame exposure times for ``times.txt``
    (the frames are written as given).  Returns the config path.
    """
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    n = len(seq.images)
    for i in range(n):
        np.save(os.path.join(root, "frames", f"{i}.npy"),
                np.asarray(seq.images[i], np.float32))
    exposures = np.ones(n) if exposures is None else exposures
    with open(os.path.join(root, "times.txt"), "w") as f:
        for i in range(n):
            f.write(f"{i} {float(seq.timestamps[i]):.6f} "
                    f"{float(exposures[i]):.6f}\n")
    cam = seq.camera
    w, h = (int(float(v)) for v in cam.image_size)
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"pinhole\n{w} {h}\n{float(cam.fx)!r} {float(cam.fy)!r} "
                f"{float(cam.cx)!r} {float(cam.cy)!r}\n")

    from dsopp_tpu.output.tum import export_tum

    gt = [(float(seq.timestamps[i]),
           np.asarray(seq.pose_t_wc(i).matrix(), np.float64))
          for i in range(n)]
    export_tum(os.path.join(root, "gt_init.tum"), gt[:init_frames])
    export_tum(os.path.join(root, "gt_full.tum"), gt)

    config = {
        "sensors": [{
            "id": "camera_1",
            "type": "camera",
            "provider": {"type": "npy_folder", "folder": "frames",
                         "timestamps": "times.txt"},
            "model": {"calibration": "calib.txt"},
        }],
        "time": {"type": "no_synchronization"},
        "tracker": tracker,
        "initializer": {"type": "precalculated", "poses_file": "gt_init.tum",
                        "num_frames": init_frames},
    }
    path = os.path.join(root, "mono.json")
    with open(path, "w") as f:
        json.dump(config, f, indent=2)
    return path
