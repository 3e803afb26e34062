"""Multi-device and multi-host tiling.

The exchange between shards lives in ops.device (ShardedExchange); this
package adds the multi-device engine (multidevice) and the host-level
coordination of multi-host runs (multihost).
"""

from .multihost import MultiHostPlan, plan_multihost_tiling  # noqa: F401
