"""Operations observability: tracing, the audit trail, the flight recorder.

The counterpart of ``gpumounter_tpu/obs/``'s ``trace``, ``audit``, ``sinks``
and ``flight``: spans with a trace id minted at the master's HTTP edge and
carried over the gRPC wire (``rpc/api.py`` field 7) to the worker, an
append-only record of every mutating operation, and one chronological
timeline of root and error spans, audit records and Kubernetes Events. The
fleet planes (``fleet``, ``slo``, ``tenants``, ``assembly``, ``capacity``)
come later. Standard library only: the mount path imports it.
"""


def configure(cfg) -> None:
    """Size the trace ring, the audit trail and the flight recorder and open
    their JSONL sinks, from config (TPUMOUNTER_TRACE_RING,
    TPUMOUNTER_TRACE_JSONL, ...). A daemon calls it once at start; the
    timeline's hooks go in with the ``MasterApp`` or ``GpuMountService``
    it builds (``flight.install``)."""
    from gpumounter_tpu_torch.obs import audit, flight, trace

    trace.configure(cfg)
    audit.configure(cfg)
    flight.configure(cfg)
