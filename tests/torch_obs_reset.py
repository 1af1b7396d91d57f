"""The port's observability globals, reset around each test that uses them.

``tests/conftest.py`` resets the reference's trace ring, audit trail, flight
recorder and metrics after every test; the port's have their own. A test
module that imports ``reset_port_obs`` gets it as an autouse fixture: the
port's TRACER, AUDIT and FLIGHT are emptied and both packages' failpoints
disarmed before and after each of its tests.
"""

from __future__ import annotations

import pytest

from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.obs import audit, flight, trace


def _reset() -> None:
    failpoints.disarm_all()
    failpoints.seed(0)
    ref_failpoints.disarm_all()
    ref_failpoints.seed(0)
    trace.TRACER.reset()
    audit.AUDIT.reset()
    flight.FLIGHT.reset()


@pytest.fixture(autouse=True)
def reset_port_obs():
    _reset()
    yield
    _reset()
