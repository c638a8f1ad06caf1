"""JSON or YAML config with dot-path overrides → application objects.

Mirrors the reference ``ConfigLoader`` (reference:
src/dsopp/src/config_loader.cpp:56-168 — YAML parsed into nested maps with
path canonization, and ``--config.a.b.0.c=v`` dot-path CLI overrides merged
before construction; :173 builds sensors/synchronizer/tracker from the
merged tree) and the fabric pattern (docs/extending_dsopp.md).

The same schema as the reference ships (mono.yaml etc.) is accepted, as
YAML or as the equivalent JSON; unknown keys warn and fall back to
defaults, like the reference fabrics.  JSON needs only the standard
library; YAML needs PyYAML.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("dsopp_tpu.config")


def load_config(path: str) -> dict:
    """``.json`` configs are read with the standard library; any other
    extension is YAML and needs PyYAML."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"{path}: YAML configs need PyYAML, which is not installed; "
                "write the same tree as a .json config instead") from e
        return yaml.safe_load(f)


_SCALAR_WORDS = {"true": True, "yes": True, "on": True,
                 "false": False, "no": False, "off": False,
                 "null": None, "~": None, "": None}


def _parse_scalar(raw: str):
    """Override value → Python scalar, the way YAML reads a plain scalar:
    numbers, booleans (true/yes/on, false/no/off), null, JSON lists or
    quoted strings; anything else stays a string."""
    try:
        return json.loads(raw)
    except ValueError:
        pass
    if raw.lower() in _SCALAR_WORDS:
        return _SCALAR_WORDS[raw.lower()]
    try:
        return float(raw)
    except ValueError:
        return raw


def apply_overrides(config: dict, overrides) -> dict:
    """Merge ``--config.a.b.0.c=value`` style overrides into the tree.

    Mirrors parseConfigArgs + updateConfig (dsopp_main.cpp:41,
    config_loader.cpp:146-168): integer path components index lists, the
    final component is replaced with the parsed scalar
    (:func:`_parse_scalar`).
    """
    import copy

    config = copy.deepcopy(config)
    for item in overrides:
        if item.startswith("--config."):
            item = item[len("--config."):]
        path, _, raw = item.partition("=")
        keys = path.split(".")
        node = config
        for key in keys[:-1]:
            node = node[int(key)] if isinstance(node, list) else node.setdefault(key, {})
        leaf = keys[-1]
        value = _parse_scalar(raw)
        if isinstance(node, list):
            node[int(leaf)] = value
        else:
            node[leaf] = value
    return config


@dataclass
class Application:
    """Constructed pipeline (reference DSOPP facade analog)."""

    camera: object        # master sensors.Camera
    tracker: object       # tracker.MonocularTracker
    config: dict
    init_poses: Optional[dict] = None   # timestamp → SE3 (bootstrap poses)
    init_frames: int = 8
    fbs_initializer: Optional[object] = None  # feature-based bootstrap
    agent: Optional[object] = None      # sensors.agent.Agent (multi-sensor rig)
    synchronizer: Optional[object] = None
    sanity_checker: Optional[object] = None  # sanity_checker.SanityChecker
    use_device_loop: bool = True        # production path = benched path
    _pipe: Optional[object] = None      # PipelinedTracker once initialized

    def _next_frame(self):
        """Pull the next master-camera frame through the synchronizer
        (reference dsopp.cpp:116 ``synchronizer_->sync(sensors)``)."""
        if self.synchronizer is not None:
            sync = self.synchronizer.sync()
            if sync is None:
                return None
            return sync.camera_frame(self.camera.sensor_id)
        return self.camera.next_frame()

    def run(self, max_frames: Optional[int] = None, on_frame=None,
            observers=None):
        """Main loop (reference dsopp.cpp:102-145): pull synchronized
        frames, feed the initializer until it produces poses (feature-based
        SLAM by default, precalculated poses_file if configured), then
        replay them into the direct tracker and continue ticking.

        ``observers``: list of :class:`dsopp_tpu.output.observers.TrackObserver`
        — per-frame notify here, keyframe/marginalization events via the
        track, ``finish`` once after the loop (reference output-interface
        set, dsopp.cpp wiring).  ``on_frame`` is the legacy single-callback
        form, kept working.
        """
        from dsopp_tpu.output.observers import CallbackObserver, ObserverSet

        obs = ObserverSet(list(observers or []))
        if on_frame is not None:
            obs.add(CallbackObserver(on_frame))
        self.tracker.track.observers.append(obs)
        try:
            n = self._run_loop(obs, max_frames)
        finally:
            # an exception mid-run must not leak the set: a retried run()
            # would double-register and fire duplicate events
            obs.finish(self.tracker)
            self.tracker.track.observers.remove(obs)
        return n

    def _run_loop(self, obs, max_frames):
        n = 0
        buffered = []   # frames retained while the FBS initializer runs
        while True:
            frame = self._next_frame()
            if frame is None or (max_frames is not None and n >= max_frames):
                break
            result = None
            if not self.tracker.is_initialized():
                if self.init_poses is not None:
                    known_pose = self._lookup_pose(frame.timestamp)
                    force_kf = n == self.init_frames - 1
                    result = self.tracker.tick(
                        frame.frame_id, frame.timestamp, frame.image,
                        known_pose=known_pose, force_keyframe=force_kf,
                        exposure=frame.exposure)
                else:
                    # feature-based bootstrap (reference dsopp.cpp:129-131)
                    import numpy as np

                    fbs = self._fbs()
                    img_np = np.asarray(frame.image)
                    buffered.append((frame.frame_id, frame.timestamp, img_np))
                    done = fbs.process(frame.frame_id, frame.timestamp, img_np)
                    if done:
                        by_id = {fid: (ts, mat) for fid, ts, mat in fbs.poses}
                        replay = [
                            (fid, ts, img, self._pose_from_matrix(by_id[fid][1]))
                            for fid, ts, img in buffered if fid in by_id
                        ]
                        self.tracker.initialize(replay)
                        buffered = []
                    result = {"keyframe": done, "bootstrap": True}
            else:
                # tracked phase: the fully device-resident loop is the
                # production path (reference dsopp_main runs the same tracker
                # it benches, dsopp_main.cpp:59-118); --host-loop opts out
                if self.use_device_loop and self._pipe is None:
                    from dsopp_tpu.tracker.device_loop import PipelinedTracker

                    self._pipe = PipelinedTracker(self.tracker, flush_every=16)
                if self._pipe is not None:
                    self._pipe.tick(frame.frame_id, frame.timestamp,
                                    frame.image, semantics=frame.semantics,
                                    exposure=frame.exposure)
                    result = {"pipelined": True}
                else:
                    result = self.tracker.tick(
                        frame.frame_id, frame.timestamp, frame.image,
                        semantics=frame.semantics, exposure=frame.exposure)
            obs.on_frame(frame, result)
            if result and result.get("keyframe"):
                self._run_sanity_check()
            n += 1
        if self._pipe is not None:
            self._pipe.finalize()
            self._pipe = None
            self._run_sanity_check()
        return n

    def _run_sanity_check(self):
        """Feed newly marginalized keyframes to the sanity checker
        (reference dsopp.cpp checks the live track per tick; here only
        host-resident snapshots are checked so the hot loop never pays an
        extra device→host readback — active-window poses are checked once
        at ``finish``)."""
        if self.sanity_checker is None:
            return
        track = self.tracker.track
        kfs = [(i, kf.timestamp, kf.t_wc)
               for i, kf in enumerate(track.marginalized)]
        if kfs:
            self.sanity_checker.check(kfs)

    def finish(self):
        """End-of-run bookkeeping: sanity-check the remaining active window."""
        if self.sanity_checker is None:
            return
        import numpy as np

        from dsopp_tpu.core.lie import SE3

        track = self.tracker.track
        window = self.tracker.window
        kfs = [(i, kf.timestamp, kf.t_wc)
               for i, kf in enumerate(track.marginalized)]
        base = len(kfs)
        poses = window.poses()
        ids = np.asarray(window.frame_id)
        for pos in range(window.frame_count()):
            fid = int(ids[pos])
            kfs.append((base + pos,
                        track.keyframe_timestamps.get(fid, 0.0),
                        np.asarray(SE3(poses.q[pos], poses.t[pos]).matrix())))
        if kfs:
            self.sanity_checker.check(kfs)

    def _fbs(self):
        if self.fbs_initializer is None:
            from dsopp_tpu.fbs import InitializerOptions, MonocularInitializer

            model = self.camera.camera_model(0)
            opts = InitializerOptions()
            init_cfg = self.config.get("initializer", {})
            fe = init_cfg.get("features_extractor", {}) or {}
            opts.num_features = int(fe.get("number_of_features",
                                           opts.num_features))
            # reference fabric: features_extractor.type: ORB selects the
            # distinct-features matcher (distinct_features_extractor_orb)
            if str(fe.get("type", "")).upper().startswith("ORB"):
                opts.matcher = "orb"
            opts.se3_inlier_ratio = float(init_cfg.get(
                "se3_inlier_ratio", opts.se3_inlier_ratio))
            opts.essential_ransac_threshold_px = float(init_cfg.get(
                "essential_matrix_ransac_threshold",
                opts.essential_ransac_threshold_px))
            opts.pnp_ransac_threshold_px = float(init_cfg.get(
                "pnp_ransac_threshold", opts.pnp_ransac_threshold_px))
            # reference fbs fabric: initializer_type calibrated|autocalibrated
            opts.autocalibrate = (
                init_cfg.get("initializer_type", "calibrated")
                == "autocalibrated")
            opts.reprojection_threshold_px = float(init_cfg.get(
                "reprojection_threshold", opts.reprojection_threshold_px))
            self.fbs_initializer = MonocularInitializer(model, opts)
        return self.fbs_initializer

    def _pose_from_matrix(self, mat):
        import jax.numpy as jnp

        from dsopp_tpu.core.lie import SE3

        return SE3.from_matrix(jnp.asarray(mat, self.tracker.dtype))

    def _lookup_pose(self, timestamp):
        import numpy as np

        import jax.numpy as jnp

        from dsopp_tpu.core.lie import SE3

        times = np.asarray(sorted(self.init_poses))
        idx = int(np.argmin(np.abs(times - timestamp)))
        mat = self.init_poses[float(times[idx])]
        dtype = self.tracker.dtype
        return SE3.from_matrix(jnp.asarray(mat, dtype))


def build_tracker_config(tracker_params: dict):
    from dsopp_tpu.tracker.monocular import TrackerConfig

    cfg = TrackerConfig()
    cfg.desired_points = int(tracker_params.get("number_of_desired_points",
                                                cfg.desired_points))
    kf = tracker_params.get("keyframe_strategy", {})
    cfg.keyframe_factor = float(kf.get("factor", cfg.keyframe_factor))
    marg = tracker_params.get("marginalization_strategy", {})
    cfg.window_min = int(marg.get("minimum_size", cfg.window_min))
    cfg.window_max = int(marg.get("maximum_size", cfg.window_max))
    cfg.max_marginalized_fraction = float(
        marg.get("maximum_percentage_of_marginalized_points_in_frame",
                 cfg.max_marginalized_fraction))
    # solver sections (reference fabric.cpp:59-160: max_iterations +
    # affine_brightness_regularizers "a b" per solver; the ×C scaling is
    # applied at solver construction)
    def _affine_reg(section, default):
        raw = section.get("affine_brightness_regularizers")
        if raw is None:
            return default
        parts = [float(x) for x in str(raw).split()]
        return (parts[0], parts[1])

    pba = tracker_params.get("photometric_bundle_adjustment", {}) or {}
    cfg.pba_max_iterations = int(pba.get("max_iterations",
                                         cfg.pba_max_iterations))
    cfg.pba_affine_reg = _affine_reg(pba, cfg.pba_affine_reg)
    pa = tracker_params.get("pose_alignment", {}) or {}
    cfg.align_affine_reg = _affine_reg(pa, cfg.align_affine_reg)

    # window_max + 2: the device loop pushes the new keyframe before the
    # marginalization fold runs (device_loop.PipelinedTracker invariant)
    cfg.num_frame_slots = cfg.window_max + 2
    cfg.landmarks_per_frame = max(
        64, cfg.desired_points // max(cfg.window_max - 1, 1))
    return cfg


def opencv_uses(config: dict) -> list:
    """The parts of ``config`` that read or transform images with OpenCV.

    The ``npy_folder`` provider and the ``precalculated`` initializer need
    neither OpenCV nor PyYAML, so a JSON config built from them runs the
    tracker on a machine that has only JAX and NumPy.
    """
    uses = []
    for s in config.get("sensors", []):
        if s.get("type") != "camera":
            continue
        sid = s.get("id", "camera")
        kind = (s.get("provider") or {}).get("type", "image_folder")
        if kind in ("image_folder", "video"):
            uses.append(f"{sid}: provider type {kind!r}")
        ratio = ((s.get("transformations") or {}).get("resize_transformer")
                 or {}).get("resize_ratio", 1.0)
        if float(ratio) != 1.0:
            uses.append(f"{sid}: resize_transformer")
        if s.get("camera_mask"):
            uses.append(f"{sid}: camera_mask")
        if (s.get("model") or {}).get("vignetting"):
            uses.append(f"{sid}: vignetting")
        if (s.get("semantics") or {}).get("folder"):
            uses.append(f"{sid}: semantics")
    init = config.get("initializer", {}) or {}
    poses_file = init.get("poses_file") or (
        (config.get("tracker", {}) or {}).get("pose_alignment", {})
        or {}).get("poses_file")
    if init.get("type") != "precalculated" and not poses_file:
        uses.append("feature-based bootstrap initializer")
    return uses


def _require_opencv(config: dict):
    uses = opencv_uses(config)
    if not uses:
        return
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "this config needs OpenCV (cv2), which is not installed: "
            + "; ".join(uses) + ".  Without it, use the npy_folder provider "
            "and the precalculated initializer") from e


def build_application(config: dict, base_dir: str = ".", dtype=None) -> Application:
    import jax.numpy as jnp

    _require_opencv(config)

    from dsopp_tpu.sensors.camera import Camera
    from dsopp_tpu.tracker.monocular import MonocularTracker

    dtype = jnp.float32 if dtype is None else dtype

    from dsopp_tpu.sensors.agent import Agent, Sensors
    from dsopp_tpu.sensors.synchronizer import create_synchronizer

    registry = Sensors()
    for i, s in enumerate(config.get("sensors", [])):
        if s.get("type") == "camera":
            registry.add_camera(Camera.from_config(
                s.get("id", f"camera_{i + 1}"), s, base_dir))
    if len(registry) == 0:
        raise ValueError("config has no camera sensor")
    agent = Agent(sensors=registry)
    synchronizer = create_synchronizer(config.get("time"), registry)
    camera = registry.get(synchronizer.master) or registry.master

    tracker_params = config.get("tracker", {})
    if tracker_params.get("type", "monocular") != "monocular":
        log.warning("unknown tracker type %r; using monocular",
                    tracker_params.get("type"))
    cfg = build_tracker_config(tracker_params)
    # frame embedder (reference camera_fabric.cpp:41-50: sensor-level
    # frame_embedder.type; gn_net is proprietary there — filter_bank is the
    # open C=3 stand-in with the same contract)
    for s in config.get("sensors", []):
        fe = s.get("frame_embedder")
        if fe and s.get("id", "camera_1") == camera.sensor_id:
            kind = str(fe.get("type", "identity"))
            if kind == "gn_net":
                raise ValueError(
                    "frame_embedder type 'gn_net' is proprietary in the "
                    "reference; use 'filter_bank' (C=3) or 'identity'")
            cfg.embedder = kind
    model = camera.camera_model(0, dtype)
    tracker = MonocularTracker(model, cfg, dtype=dtype,
                               mask=camera.processed_mask())
    tracker.semantic_filter = tuple(camera.semantic_filter)

    # bootstrap: precalculated poses (reference precalculated_pose_alignment /
    # pose_alignment poses_file).  The feature-based initializer plugs in the
    # same way once poses are unavailable.
    init_poses = None
    init_frames = 8
    init_params = config.get("initializer", {})
    poses_file = init_params.get("poses_file") or (
        tracker_params.get("pose_alignment", {}) or {}).get("poses_file")
    if init_params.get("type") == "precalculated" or poses_file:
        from dsopp_tpu.output.tum import load_tum

        entries = load_tum(os.path.join(base_dir, poses_file))
        init_poses = {float(t): m for t, m in entries}
        init_frames = int(init_params.get("num_frames", init_frames))

    from dsopp_tpu.sanity_checker import create_sanity_checker

    sanity = create_sanity_checker(config.get("sanity_checker"), base_dir)

    return Application(camera=camera, tracker=tracker, config=config,
                       init_poses=init_poses, init_frames=init_frames,
                       agent=agent, synchronizer=synchronizer,
                       sanity_checker=sanity,
                       use_device_loop=bool(config.get("device_loop", True)))
