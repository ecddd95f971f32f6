"""Topology re-export (counterpart of
`paddle_tpu/distributed/fleet/base/topology.py`): the implementation lives
in `distributed.mesh`."""
from ...mesh import CommunicateTopology, HybridCommunicateGroup  # noqa: F401
