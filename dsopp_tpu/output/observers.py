"""Observer-style output interfaces.

JAX analog of the reference output-interface set (reference:
src/output/include/output_interfaces/ — TrackOutputInterface observers
registered on the track, notified per event, finished at shutdown;
dsopp.cpp wires them to the visualizer/storage/metrics).  Here observers
attach to :class:`~dsopp_tpu.track.state.OdometryTrack` (keyframe /
marginalization events, which fire from BOTH the host loop and the batched
device-loop bookkeeping) and to :class:`~dsopp_tpu.config.loader.Application`
(per-frame notify + finish).

All callbacks are host-side and outside the jitted device programs — an
observer can never perturb the tracked state or its performance
(diagnostics arrive through the same batched readbacks the track uses).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional


class TrackObserver:
    """Base observer: every hook is a no-op (subclass what you need).

    Hooks mirror the reference interface set: per-frame ``notify``
    (output_interface.hpp), keyframe/marginalization events (track
    storage observers), and ``finish`` (called once after the run).
    """

    def on_frame(self, frame, result) -> None:            # notify()
        pass

    def on_keyframe(self, frame_id: int, timestamp: float) -> None:
        pass

    def on_marginalize(self, kf) -> None:                 # MarginalizedKeyframe
        pass

    def finish(self, tracker) -> None:
        pass


class ObserverSet(TrackObserver):
    """Fan-out container; also a TrackObserver itself."""

    def __init__(self, observers: Optional[List[TrackObserver]] = None):
        self.observers: List[TrackObserver] = list(observers or [])

    def add(self, obs: TrackObserver) -> "ObserverSet":
        self.observers.append(obs)
        return self

    def on_frame(self, frame, result):
        for o in self.observers:
            o.on_frame(frame, result)

    def on_keyframe(self, frame_id, timestamp):
        for o in self.observers:
            o.on_keyframe(frame_id, timestamp)

    def on_marginalize(self, kf):
        for o in self.observers:
            o.on_marginalize(kf)

    def finish(self, tracker):
        for o in self.observers:
            o.finish(tracker)


class CallbackObserver(TrackObserver):
    """Adapts the legacy ``on_frame(frame, result)`` callable."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def on_frame(self, frame, result):
        self._fn(frame, result)


class FpsMeter(TrackObserver):
    """Runtime frames/s meter (reference dsopp.cpp:45-73 runtime meter)."""

    def __init__(self):
        self.start: Optional[float] = None
        self.frames = 0
        self.keyframes = 0

    def on_frame(self, frame, result):
        if self.start is None:
            self.start = time.time()
        self.frames += 1

    def on_keyframe(self, frame_id, timestamp):
        self.keyframes += 1

    @property
    def fps(self) -> float:
        if self.start is None or self.frames == 0:
            return 0.0
        elapsed = max(time.time() - self.start, 1e-9)
        return self.frames / elapsed


class TrajectoryWriter(TrackObserver):
    """Writes the final TUM trajectory at ``finish`` (storage observer)."""

    def __init__(self, path: str):
        self.path = path

    def finish(self, tracker):
        from dsopp_tpu.output.tum import export_tum

        export_tum(self.path, tracker.track.trajectory(tracker.window))
