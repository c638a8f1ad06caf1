"""dsopp_tpu — direct sparse odometry in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA reimplementation of the capabilities of
RoadlyInc/DSOPP (direct sparse odometry: photometric sliding-window bundle
adjustment, coarse-to-fine direct image alignment, epipolar immature-point
depth filtering), architected for an accelerator:

* state is fixed-shape, batched, and masked (keyframe slots, landmark slots);
* hot loops (residual/Jacobian evaluation, Hessian assembly, Schur
  complement) are batched contractions at full f32 precision;
* per-level solves are jitted `lax.while_loop`s; host code only takes
  data-independent decisions from scalar summaries;
* multi-device scaling shards landmarks/frame-pairs over a
  `jax.sharding.Mesh` and reduces Hessians with `psum`.

Layer map (mirrors reference SURVEY.md §1, re-designed for an accelerator):
  core/      SE3 Lie math, camera models, reprojection, patterns, interpolation
  features/  pyramids, gradients, candidate-point extraction
  sensors/   providers, calibration, undistortion, masks
  solvers/   LM driver, pose alignment, photometric BA, depth estimation
  track/     fixed-shape sliding-window state (keyframes, landmarks, statuses)
  tracker/   per-frame tick orchestration, keyframe/marginalization policy
  fbs/       feature-based bootstrap initializer
  output/    trajectory + track serialization, exporters
  parallel/  mesh/sharding layer, distributed Hessian assembly
  ops/       packed sampling layouts for the hot paths (plain JAX)
  config/    JSON/YAML config with dot-path overrides, fabrics
  app/       CLI entry points
"""

__version__ = "0.1.0"
