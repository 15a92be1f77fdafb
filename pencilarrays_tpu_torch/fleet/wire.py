"""The fleet's KV wire protocol — key layout + request/result codec.

Every cross-mesh interaction rides the SAME KV backend the cluster
layer already trusts (:mod:`pencilarrays_tpu_torch.cluster.kv`): requests,
results, health beats, load exports and stop signals are all plain
keys under one ``<ns>/fleet`` prefix, so a FileKV drill, a StoreKV
deployment and the chaos tests all speak one protocol.

Key families (``m<k>`` = mesh id, ``t<id>`` = fleet ticket id)::

    <ns>/fleet/beat/m<k>/b<n>   sequence-numbered heartbeat (health.py;
                                one-round-lag GC keeps <= 2 live keys)
    <ns>/fleet/left/m<k>        durable clean-departure record
    <ns>/fleet/load/m<k>        the mesh's load/affinity export (one
                                overwritten key: projection snapshot +
                                warm plan fingerprints)
    <ns>/fleet/req/m<k>/t<id>   a routed request, owned by mesh k
                                until it publishes the result and
                                deletes the key
    <ns>/fleet/res/t<id>        the result (ok payload or typed
                                error), deleted by the router once the
                                ticket resolves
    <ns>/fleet/stop/m<k>        supervisor/drill retire signal

Payload arrays cross the wire as base64-encoded ``.npy`` bytes — the
host-array *global logical* form, which is exactly the rebind-safe
form the serve layer already requires for elastic reformation: a
request that failed over to a sibling mesh re-scatters onto whatever
topology that mesh runs.  Typed serve errors cross as
``(type, message, kwargs)`` triples and are re-raised as the SAME
typed class on the router side, so the client-facing contract
(result / ``DeadlineError`` / ``AdmissionError``) survives the hop.
"""

from __future__ import annotations

import base64
import io as _io
import json
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "fleet_ns", "beat_dir", "beat_key", "left_key", "load_key",
    "req_dir", "req_key", "res_key", "stop_key",
    "encode_array", "decode_array", "encode_request", "decode_request",
    "encode_result", "decode_result", "ticket_id_of",
]


# ---------------------------------------------------------------------------
# key layout (the ONE place the fleet namespace is spelled)
# ---------------------------------------------------------------------------

def fleet_ns(namespace: str = "pa") -> str:
    return f"{namespace}/fleet"


def beat_dir(namespace: str, mesh: int) -> str:
    return f"{fleet_ns(namespace)}/beat/m{mesh}"


def beat_key(namespace: str, mesh: int, n: int) -> str:
    # zero-padded so FileKV's sorted listing is numeric order
    return f"{beat_dir(namespace, mesh)}/b{n:012d}"


def left_key(namespace: str, mesh: int) -> str:
    return f"{fleet_ns(namespace)}/left/m{mesh}"


def load_key(namespace: str, mesh: int) -> str:
    return f"{fleet_ns(namespace)}/load/m{mesh}"


def req_dir(namespace: str, mesh: int) -> str:
    return f"{fleet_ns(namespace)}/req/m{mesh}"


def req_key(namespace: str, mesh: int, ticket_id: str) -> str:
    return f"{req_dir(namespace, mesh)}/t{ticket_id}"


def res_key(namespace: str, ticket_id: str) -> str:
    return f"{fleet_ns(namespace)}/res/t{ticket_id}"


def stop_key(namespace: str, mesh: int) -> str:
    return f"{fleet_ns(namespace)}/stop/m{mesh}"


def ticket_id_of(key: str) -> str:
    """The ticket id embedded in a req/res key's last segment."""
    seg = key.rsplit("/", 1)[-1]
    return seg[1:] if seg.startswith("t") else seg


# ---------------------------------------------------------------------------
# payload codec
# ---------------------------------------------------------------------------

def encode_array(a) -> dict:
    """A host array as a JSON-safe ``.npy`` capsule (dtype + shape +
    strides all ride the npy header — no hand-rolled metadata)."""
    buf = _io.BytesIO()
    np.save(buf, np.asarray(a), allow_pickle=False)
    return {"npy": base64.b64encode(buf.getvalue()).decode("ascii")}


def decode_array(d: dict) -> np.ndarray:
    return np.load(_io.BytesIO(base64.b64decode(d["npy"])),
                   allow_pickle=False)


def encode_request(ticket_id: str, *, tenant: str, name: str,
                   direction: str, payload, t_submit: float,
                   deadline_s: Optional[float] = None,
                   rebinds: int = 0,
                   trace: Optional[str] = None) -> str:
    """One routed request as a KV value.  ``name`` addresses a plan
    registered on the back-end (requests cross meshes by NAME, never
    by plan object — each mesh builds the plan on its own topology).
    ``trace`` is the request's trace context (obs/requestflow.py),
    minted once at router admission and PROPAGATED on every re-encode
    — a rebind that re-minted would shear the causal chain exactly at
    the failover the post-mortem cares about (the trace-ctx lint
    audits every call site)."""
    return json.dumps({
        "ticket": ticket_id, "tenant": tenant, "name": name,
        "direction": direction, "t_submit": t_submit,
        "deadline_s": deadline_s, "rebinds": rebinds,
        "trace": trace,
        "payload": encode_array(payload),
    })


def decode_request(raw: str) -> dict:
    d = json.loads(raw)
    d["payload"] = decode_array(d["payload"])
    return d


# typed classes allowed to cross the wire and re-raise on the router
# side; anything else degrades to FleetError with the original name
# in the message (never a silent swallow, never arbitrary unpickling)
def _error_registry() -> dict:
    from ..resilience.errors import InjectedFault
    from ..serve.errors import (AdmissionError, DeadlineError, ServeError,
                                ServiceClosedError, StaleRequestError)

    return {
        "AdmissionError": AdmissionError,
        "DeadlineError": DeadlineError,
        "StaleRequestError": StaleRequestError,
        "ServiceClosedError": ServiceClosedError,
        "ServeError": ServeError,
        "InjectedFault": InjectedFault,
    }


def encode_result(ticket_id: str, *, value=None,
                  error: Optional[BaseException] = None,
                  seconds: Optional[float] = None,
                  mesh: Optional[int] = None) -> str:
    """A completion as a KV value: exactly one of ``value`` (the host
    result array) or ``error`` (a typed exception)."""
    if (value is None) == (error is None):
        raise ValueError("encode_result needs exactly one of "
                         "value/error")
    out = {"ticket": ticket_id, "seconds": seconds, "mesh": mesh}
    if error is not None:
        kwargs = {}
        for attr in ("tenant", "reason", "deadline_s", "projected_s",
                     "point", "hit"):
            v = getattr(error, attr, None)
            if isinstance(v, (str, int, float)) or v is None:
                if v is not None:
                    kwargs[attr] = v
        out["error"] = {"type": type(error).__name__,
                        "message": str(error), "kwargs": kwargs}
    else:
        out["value"] = encode_array(value)
    return json.dumps(out)


def decode_result(raw: str) -> Tuple[dict, Optional[np.ndarray],
                                     Optional[BaseException]]:
    """``(meta, value, error)`` — exactly one of value/error is set."""
    d = json.loads(raw)
    meta = {k: d.get(k) for k in ("ticket", "seconds", "mesh")}
    if "error" in d:
        e = d["error"]
        cls = _error_registry().get(e.get("type"))
        kwargs = e.get("kwargs") or {}
        if cls is None:
            from .errors import FleetError

            err: BaseException = FleetError(
                f"{e.get('type', 'Error')}: {e.get('message', '')}")
        else:
            try:
                err = cls(e.get("message", ""), **kwargs)
            except TypeError:
                from .errors import FleetError

                err = FleetError(
                    f"{e.get('type')}: {e.get('message', '')} "
                    f"(wire kwargs {kwargs!r} did not reconstruct)")
        return meta, None, err
    return meta, decode_array(d["value"]), None
