"""Helpers of the port's server parity tests: a server of each package in
this process (the JAX package's on the conftest's JAX CPU, the port's on
device="cpu"), each side's client modules, and the normalisation of the
parts of a reply that differ by nature: times, session ids and device
lists, which are compared by their keys and types only."""

import contextlib
import functools
import threading
import types

import heavydb_tpu.cli as jcli
import heavydb_tpu.client.dbapi as jdbapi
import heavydb_tpu.server.http_server as jhttp
import heavydb_tpu.server.server as jserver
import heavydb_tpu_torch.cli as tcli
import heavydb_tpu_torch.client.dbapi as tdbapi
import heavydb_tpu_torch.server.http_server as thttp
import heavydb_tpu_torch.server.server as tserver
from heavydb_tpu import errors as jerrors
from heavydb_tpu.client import client as jclient
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu_torch import errors as terrors
from heavydb_tpu_torch.client import client as tclient
from heavydb_tpu_torch.config import Config as TConfig
from torch_pair import same as pair_same

REF = types.SimpleNamespace(
    name="ref", server=jserver, client=jclient, dbapi=jdbapi, cli=jcli,
    errors=jerrors, Config=JConfig, serve=jserver.serve,
    HeavyTpuServer=jserver.HeavyTpuServer, serve_http=jhttp.serve_http)
PORT = types.SimpleNamespace(
    name="port", server=tserver, client=tclient, dbapi=tdbapi, cli=tcli,
    errors=terrors, Config=TConfig,
    serve=functools.partial(tserver.serve, device="cpu"),
    HeavyTpuServer=functools.partial(tserver.HeavyTpuServer, device="cpu"),
    serve_http=functools.partial(thttp.serve_http, device="cpu"))
SIDES = (REF, PORT)

# reply keys whose values are times, session ids or devices
VOLATILE = {"execution_time_ms", "uptime_s", "elapsed_ms", "start_time",
            "update_time", "ms", "session", "devices"}


def shape(v):
    """A value's keys and types, not its contents."""
    if isinstance(v, dict):
        return {k: shape(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [shape(x) for x in v]
    return type(v).__name__


def norm(v):
    """A reply with its VOLATILE entries replaced by their shapes; a device
    list by the distinct shapes of its entries (one process's JAX CPU has
    eight devices, the port's CPU one)."""
    if isinstance(v, dict):
        return {k: (sorted({repr(shape(d)) for d in x}) if k == "devices"
                    else shape(x) if k in VOLATILE else norm(x)) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    return v


def same(got, want) -> bool:
    """Equal, but floats within rtol 1e-9 (sums whose order of addition
    differs), through lists, tuples and dicts."""
    if isinstance(want, dict) and isinstance(got, dict):
        return got.keys() == want.keys() and all(same(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        return len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))
    return pair_same(got, want)


def start(srv):
    """Serve `srv` (a TCP or HTTP server) on a daemon thread."""
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return srv


def stop(srv):
    srv.shutdown()
    srv.server_close()
    core = getattr(srv, "engine", None) or getattr(srv, "core", None)
    if core is not None:
        core.db.refresh_scheduler.stop()


@contextlib.contextmanager
def serving(side, **kw):
    """A TCP server of `side` on an ephemeral port, stopped at the end."""
    srv = start(side.serve(port=0, **kw))
    try:
        yield srv
    finally:
        stop(srv)


@contextlib.contextmanager
def connected(side, srv, **kw):
    host, port = srv.server_address
    with side.client.Connection(host, port, **kw) as c:
        yield c


def recorded(conn, method: str, **params):
    """One RPC's reply, or its error's type and message, normalised."""
    try:
        return ("ok", norm(conn.call(method, **params)))
    except conn_error(conn) as e:
        return ("error", e.type, str(e))


def conn_error(conn):
    """The ServerError class of the package `conn` comes from."""
    return (tclient if isinstance(conn, tclient.Connection) else jclient).ServerError
