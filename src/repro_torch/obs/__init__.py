"""Observability of the port: the span tracer (``trace``).

    from repro_torch.obs import trace
    with trace.enabled():
        plan = plan_for(...)             # engine.plan_for, engine.demote
        plan.mttkrp(factors, 0)          # plan.mttkrp, store.read, ...
    names = [s.name for s in trace.spans()]

The JAX package's histograms, bandwidth ledger, roofline, SLOs and
exporters (``repro.obs``) are not ported yet.
"""
from . import trace
from .trace import (TRACING, add_event, clear, disable, drain, enable,
                    is_enabled, span, spans)

__all__ = ["trace", "TRACING", "span", "add_event", "enable", "disable",
           "is_enabled", "clear", "spans", "drain"]
