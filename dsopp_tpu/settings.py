"""Global numeric settings.

The reference keeps a single ``Precision`` scalar switchable between float and
double (reference: src/common/include/common/settings.hpp:9-17, USE_FLOAT cmake
option).  On an accelerator the productive dtype is float32; float64 runs
at a small fraction of its rate.  We therefore:

* default every array to ``float32``;
* keep library code dtype-polymorphic (dtype follows the inputs), so CPU tests
  can run the identical code in float64 as a high-precision oracle;
* accumulate the marginalization prior in ``float64`` on host-visible small
  systems (the reference keeps ``system_marginalized_`` in double for the same
  reason) or compensated float32 on device.
"""

import jax.numpy as jnp

# Default scalar dtype for on-device state.
dtype = jnp.float32

# Dtype for the persistent marginalization ledger (small dense system).
marg_dtype = jnp.float64

# Small epsilon used to guard divisions at the working precision.
def eps_for(dt) -> float:
    return 1e-12 if dt == jnp.float64 else 1e-8
