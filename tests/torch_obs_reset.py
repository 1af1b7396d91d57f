"""The port's observability globals, reset around each test that uses them.

``tests/conftest.py`` resets the reference's trace ring, audit trail, flight
recorder and metrics after every test; the port's have their own. A test
module that imports ``reset_port_obs`` gets it as an autouse fixture: the
port's TRACER, AUDIT, FLIGHT, the store of federated spans (REMOTE_SPANS)
and the tenant store (TENANTS) are emptied, its ApiHealth machines dropped
(``k8s.health.reset_all``: one test's outage must leave no verdict to the
next) and both packages' failpoints disarmed before and after each of its
tests.
"""

from __future__ import annotations

import pytest

from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s import health
from gpumounter_tpu_torch.obs import assembly, audit, flight, tenants, trace


def _reset() -> None:
    failpoints.disarm_all()
    failpoints.seed(0)
    ref_failpoints.disarm_all()
    ref_failpoints.seed(0)
    trace.TRACER.reset()
    audit.AUDIT.reset()
    flight.FLIGHT.reset()
    assembly.REMOTE_SPANS.reset()
    tenants.TENANTS.reset()
    health.reset_all()


@pytest.fixture(autouse=True)
def reset_port_obs():
    _reset()
    yield
    _reset()
