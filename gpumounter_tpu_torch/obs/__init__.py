"""Operations observability: tracing, the audit trail, the flight recorder.

The counterpart of ``gpumounter_tpu/obs/``'s ``trace``, ``audit``, ``sinks``
and ``flight``: spans with a trace id minted at the master's HTTP edge and
carried over the gRPC wire (``rpc/api.py`` field 7) to the worker, an
append-only record of every mutating operation, and one chronological
timeline of root and error spans, audit records and Kubernetes Events; and
the fleet planes: ``tenants`` (the worker's store of tenant snapshots),
``fleet`` (the master's collector of every worker's telemetry),
``assembly`` (the workers' spans joined with the master's into one trace)
and ``slo`` (burn rates over the fleet's rollup). The reference's
``capacity`` comes with the capacity features. Standard library only: the
mount path imports it.
"""


def configure(cfg) -> None:
    """Size the trace ring, the audit trail, the flight recorder and the
    store of federated spans and open their JSONL sinks, from config
    (TPUMOUNTER_TRACE_RING, TPUMOUNTER_TRACE_JSONL, ...,
    TPUMOUNTER_REMOTE_SPAN_CAPACITY). A daemon calls it once at start; the
    timeline's hooks go in with the ``MasterApp`` or ``GpuMountService``
    it builds (``flight.install``)."""
    from gpumounter_tpu_torch.obs import assembly, audit, flight, trace

    trace.configure(cfg)
    audit.configure(cfg)
    flight.configure(cfg)
    assembly.configure(cfg)
