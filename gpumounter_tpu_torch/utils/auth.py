"""The control plane's authentication: one shared bearer secret a deploy.

The counterpart of ``gpumounter_tpu/utils/auth.py``. The original GPUMounter
serves its control plane open (the master dials the worker insecure,
``cmd/GPUMounter-master/main.go:82``, and its HTTP API checks nothing), yet
``removegpu .../force/true`` kills the tenant's processes. Here:

  * one secret a deploy, from TPUMOUNTER_AUTH_TOKEN or the file named by
    TPUMOUNTER_AUTH_TOKEN_FILE (the project keeps its variable names);
  * the worker's gRPC server wants ``authorization: Bearer <secret>`` on
    every mount call (its health service stays open for probes);
  * the master's HTTP API wants ``Authorization: Bearer <secret>`` on every
    route but the index and /healthz;
  * it fails closed: in the default "token" mode a daemon with no secret
    refuses to start; serving open takes TPUMOUNTER_AUTH=insecure.

A second secret, optional, is the read scope (TPUMOUNTER_AUTH_READ_TOKEN
or the file TPUMOUNTER_AUTH_READ_TOKEN_FILE): the master's observability
reads (/metrics, /fleet, /slo, /tenants, /audit, /trace, /timeline,
/apihealth, /shards) and the worker's ops port take it, and no mutation
does; the mutate secret implies read. Comparisons are constant-time.
"""

from __future__ import annotations

import hmac

from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("auth")

AUTH_MODE_TOKEN = "token"
AUTH_MODE_INSECURE = "insecure"


class AuthConfigError(Exception):
    """The daemon's auth configuration is unusable (fail-closed)."""


def resolve_token(cfg) -> str | None:
    """The shared secret, or None when none is configured.
    TPUMOUNTER_AUTH_TOKEN wins over TPUMOUNTER_AUTH_TOKEN_FILE, whose
    content is stripped."""
    if cfg.auth_token:
        return cfg.auth_token
    path = cfg.auth_token_file
    if path:
        try:
            with open(path, encoding="utf-8") as f:
                token = f.read().strip()
        except OSError as exc:
            raise AuthConfigError(f"auth token file {path!r} unreadable: {exc}") from exc
        if not token:
            raise AuthConfigError(f"auth token file {path!r} is empty")
        return token
    return None


def resolve_read_token(cfg) -> str | None:
    """The read scope's secret, or None when none is configured (then
    /metrics stays open and the other reads want the mutate secret).
    TPUMOUNTER_AUTH_READ_TOKEN wins over TPUMOUNTER_AUTH_READ_TOKEN_FILE,
    whose content is stripped."""
    if cfg.auth_read_token:
        return cfg.auth_read_token
    path = cfg.auth_read_token_file
    if path:
        try:
            with open(path, encoding="utf-8") as f:
                token = f.read().strip()
        except OSError as exc:
            raise AuthConfigError(f"read token file {path!r} unreadable: {exc}") from exc
        if not token:
            raise AuthConfigError(f"read token file {path!r} is empty")
        return token
    return None


def required_token(cfg, role: str) -> str | None:
    """A daemon's secret at start: the secret in "token" mode, None under
    the explicit "insecure" opt-in; AuthConfigError when "token" mode has
    no secret or the mode is unknown. `role` names the daemon in messages."""
    mode = cfg.auth_mode or AUTH_MODE_TOKEN
    if mode == AUTH_MODE_INSECURE:
        logger.warning("%s starting with TPUMOUNTER_AUTH=insecure: the control plane "
                       "accepts requests from any peer (a forced remove kills the "
                       "tenant's processes)", role)
        return None
    if mode != AUTH_MODE_TOKEN:
        raise AuthConfigError(f"unknown TPUMOUNTER_AUTH mode {mode!r} "
                              f"(expected {AUTH_MODE_TOKEN!r} or {AUTH_MODE_INSECURE!r})")
    token = resolve_token(cfg)
    if not token:
        raise AuthConfigError(
            f"{role}: TPUMOUNTER_AUTH=token (the default) but neither "
            f"TPUMOUNTER_AUTH_TOKEN nor TPUMOUNTER_AUTH_TOKEN_FILE is set; set one, or "
            f"opt in to TPUMOUNTER_AUTH=insecure explicitly")
    return token


def check_bearer(header_value: str | None, token: str) -> bool:
    """Constant-time check of an `Authorization: Bearer <x>` value."""
    if not header_value:
        return False
    scheme, _, presented = header_value.partition(" ")
    if scheme.lower() != "bearer":
        return False
    # As bytes: compare_digest refuses non-ASCII str, which would turn a
    # garbage header into a 500 instead of a 401.
    return hmac.compare_digest(presented.strip().encode("utf-8", "surrogateescape"),
                               token.encode("utf-8", "surrogateescape"))
