"""The master replicas' HTTP client: failover across replicas and shard
redirects.

The counterpart of ``gpumounter_tpu/rpc/http_failover.py``. With sharded
masters (``master/shard.py``) a client holds a LIST of replica URLs, any of
which serves any request: a replica that does not own the target's node
answers 307 with the owner's URL. This client is the other half of that
contract, for the CLI's comma-separated ``--master`` and any script that
drives the replicas:

  * endpoints are tried in order from the last one that answered (a healthy
    replica keeps serving);
  * a transport failure fails over to the next endpoint, but for a mutation
    (POST, PUT, PATCH: the HTTP API carries no idempotency key) only a
    failure that proves the request never reached a server (connection
    refused, DNS) does; an ambiguous one (a timeout, a reset mid-exchange)
    raises, since the first replica may already have mounted;
  * 307/302/301 are followed up to `max_redirects`, the body sent again
    (urllib alone refuses a redirected POST);
  * a 503 (a degraded worker, an unowned shard) fails over once to the next
    endpoint before it is answered: another replica may own the shard by
    now.

Stdlib only.
"""

from __future__ import annotations

import json as jsonlib
import socket
import urllib.error
import urllib.parse
import urllib.request

from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("rpc.http_failover")


class EndpointError(OSError):
    """Every endpoint failed at the transport level."""


#: methods safe to re-send to another replica after ANY transport
#: failure. Mutations are not in here: the HTTP API carries no
#: idempotency key, so an ambiguous failure must surface.
_IDEMPOTENT_METHODS = frozenset({"GET", "HEAD"})


def _never_reached_server(exc: Exception) -> bool:
    """True only for failures that prove the request was never sent:
    connection refused / no route / DNS. Timeouts and resets are
    ambiguous — the server may have processed the request."""
    reason = getattr(exc, "reason", exc)
    return isinstance(reason, (ConnectionRefusedError, socket.gaierror))


class MasterEndpoints:
    def __init__(self, masters: str | list[str], token: str | None = None,
                 timeout_s: float = 360.0, max_redirects: int = 4):
        if isinstance(masters, str):
            masters = masters.split(",")
        self.bases = [m.strip().rstrip("/") for m in masters if m.strip()]
        if not self.bases:
            raise ValueError("no master endpoints given")
        self.token = token
        self.timeout_s = timeout_s
        self.max_redirects = max_redirects
        self._preferred = 0

    # --- request plumbing ---

    def _headers(self, json_body, extra: dict | None) -> dict:
        headers = dict(extra or {})
        if json_body is not None:
            headers["Content-Type"] = "application/json"
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    @staticmethod
    def _encode(form, json_body) -> bytes | None:
        if json_body is not None:
            return jsonlib.dumps(json_body).encode()
        if form is not None:
            return urllib.parse.urlencode(form, doseq=True).encode()
        return None

    def _one(self, method: str, url: str, data: bytes | None,
             headers: dict) -> tuple[int, str, dict]:
        """One exchange; returns (status, body, response headers).
        HTTPError is an answer, not a failure — redirects and 4xx/5xx
        all carry meaning here. Transport errors propagate."""
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return resp.status, resp.read().decode(), dict(resp.headers)
        except urllib.error.HTTPError as exc:
            body = exc.read().decode()
            return exc.code, body, dict(exc.headers)

    def request(self, method: str, path: str, form: dict | None = None,
                json_body: dict | None = None,
                headers: dict | None = None) -> tuple[int, str]:
        """(status, body) from the first endpoint that answers, shard
        redirects followed. Raises EndpointError only when every
        endpoint fails at the transport level."""
        data = self._encode(form, json_body)
        send_headers = self._headers(json_body, headers)
        order = [(self._preferred + i) % len(self.bases)
                 for i in range(len(self.bases))]
        last_exc: Exception | None = None
        deferred_503: tuple[int, str] | None = None
        for idx in order:
            url = self.bases[idx] + path
            try:
                status, body = self._follow(method, url, data, send_headers)
            except EndpointError:
                raise  # redirect loop: a real answer, not unreachability
            except (urllib.error.URLError, OSError, TimeoutError) as exc:
                if method not in _IDEMPOTENT_METHODS \
                        and not _never_reached_server(exc):
                    # Ambiguous mutation outcome (timeout / mid-exchange
                    # reset): the replica may have executed it. Re-POSTing
                    # elsewhere could mount twice — surface instead.
                    raise EndpointError(
                        f"{method} {path} to {self.bases[idx]} failed "
                        f"ambiguously ({exc}); not retrying a mutation "
                        f"elsewhere — check the master's /audit for "
                        f"whether it landed") from exc
                logger.warning("master %s unreachable (%s); failing over",
                               self.bases[idx], exc)
                last_exc = exc
                continue
            if status == 503 and deferred_503 is None \
                    and idx != order[-1]:
                # Unowned shard / degraded worker: one more replica may
                # route better. Remember the answer in case they all say
                # 503 — that IS the fleet's honest state then.
                deferred_503 = (status, body)
                continue
            self._preferred = idx
            return status, body
        if deferred_503 is not None:
            return deferred_503
        raise EndpointError(
            f"no master endpoint reachable (tried {self.bases}): "
            f"{last_exc}")

    def _follow(self, method: str, url: str, data: bytes | None,
                headers: dict) -> tuple[int, str]:
        """Follow shard redirects, re-sending method AND body (307
        semantics; urllib alone refuses redirected POSTs)."""
        for _ in range(self.max_redirects + 1):
            status, body, resp_headers = self._one(method, url, data,
                                                   headers)
            if status not in (301, 302, 307):
                return status, body
            location = next((v for k, v in resp_headers.items()
                             if k.lower() == "location"), None)
            if not location:
                return status, body
            url = urllib.parse.urljoin(url, location)
            logger.debug("following shard redirect to %s", url)
        raise EndpointError(
            f"redirect loop: more than {self.max_redirects} hops "
            f"(last: {url})")
