"""The registered lint passes of the port.

The reference's six pass ids, so baselines and inline suppressions spell
the same in both packages.  ``span_hygiene``, ``lock_discipline`` and
``fault_site_hygiene`` are copies; ``dtype_promotion``, ``host_sync`` and
``unfenced_timing`` are torch twins of the reference's jnp-keyed passes.
See the individual modules for the bug class each one traces to.
"""
from .dtype_promotion import DtypePromotionPass
from .fault_site_hygiene import FaultSiteHygienePass
from .host_sync import HostSyncPass
from .lock_discipline import LockDisciplinePass
from .span_hygiene import SpanHygienePass
from .unfenced_timing import UnfencedTimingPass

REGISTRY = [
    DtypePromotionPass,
    HostSyncPass,
    UnfencedTimingPass,
    LockDisciplinePass,
    SpanHygienePass,
    FaultSiteHygienePass,
]

__all__ = ["REGISTRY", "DtypePromotionPass", "FaultSiteHygienePass",
           "HostSyncPass", "UnfencedTimingPass", "LockDisciplinePass",
           "SpanHygienePass"]
