"""The port's service wire (``petastorm_tpu_torch/service/wire.py`` and
``protocol.py``) against the JAX package's, on the CPU.

After ``tests/test_service.py``'s protocol and wire-robustness cases: the
same control dicts, seeded column batches (under each codec), work items
with their trace context and hello frames encode to equal bytes in both
packages; each package decodes the other's frames to equal values; the same
malformed input raises the same classified error with the same message in
both; and ``negotiate_codec``, ``parse_address``, the auth check and the
dispatcher's worker-affinity pick decide alike.  Every socket read is
bounded by a timeout.
"""

import functools
import os
import pickle
import socket
import struct
import threading
import types

import numpy as np
import pytest

from petastorm_tpu import batch as jax_batch
from petastorm_tpu import pool as jax_pool
from petastorm_tpu.errors import PetastormTpuError as JaxPetastormTpuError
from petastorm_tpu.service import client as jax_client
from petastorm_tpu.service import dispatcher as jax_dispatcher
from petastorm_tpu.service import protocol as jax_protocol
from petastorm_tpu.service import wire as jax_wire
from petastorm_tpu.service import worker as jax_service_worker
from petastorm_tpu.telemetry import Telemetry as JaxTelemetry

from petastorm_tpu_torch import batch, pool
from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.service import client, dispatcher, protocol, wire
from petastorm_tpu_torch.service import worker as service_worker
from petastorm_tpu_torch.telemetry import Telemetry

PKGS = {
    "jax": types.SimpleNamespace(wire=jax_wire, protocol=jax_protocol, batch=jax_batch,
                                 pool=jax_pool, dispatcher=jax_dispatcher, client=jax_client,
                                 worker=jax_service_worker, Telemetry=JaxTelemetry,
                                 error=JaxPetastormTpuError),
    "torch": types.SimpleNamespace(wire=wire, protocol=protocol, batch=batch, pool=pool,
                                   dispatcher=dispatcher, client=client,
                                   worker=service_worker, Telemetry=Telemetry,
                                   error=PetastormTpuError),
}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]

CONTROL_VALUES = {
    "none": None, "true": True, "false": False, "zero": 0, "neg": -(2 ** 62),
    "float": 3.5, "str": "héllo", "bytes": b"\x00\xff", "nested": [1, [2, [3]]],
    "dict": {"a": {"b": [None, "x"]}},
    "ndarray": np.arange(6, dtype=np.float32).reshape(2, 3),
    "strided": np.arange(12, dtype=np.int16).reshape(3, 4)[:, ::2],
    "empty": np.zeros((0, 3), dtype=np.uint8),
    "ack": {"t": "ack", "ordinals": [0, 1, 2, 3, 4, 5, 6, 7]},
    "heartbeat": {"t": "heartbeat", "busy": 2,
                  "counters": {"worker.rowgroups_decoded": 3.0, "decode.rows": 48.0}},
    "failure": {"t": "failure", "client": "c0", "ordinal": 9, "attempt": 1,
                "formatted": "Traceback ...\nValueError: bad\n", "kind": "data",
                "exc_type": "ValueError"},
    "stats": {"t": "client_stats", "starved_s": 0.125},
    "np_scalars": {"i": np.int64(7), "f": np.float32(0.5)},
}


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(CONTROL_VALUES))
def test_control_codec_writes_the_jax_bytes(name):
    value = CONTROL_VALUES[name]
    assert wire.dumps(value) == jax_wire.dumps(value)


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=lambda d: d)
@pytest.mark.parametrize("name", sorted(CONTROL_VALUES))
def test_control_codec_cross_decodes(name, src, dst):
    value = CONTROL_VALUES[name]
    got = PKGS[dst].wire.loads(PKGS[src].wire.dumps(value))
    expect = jax_wire.loads(jax_wire.dumps(value))  # np scalars come back as ints/floats
    assert _equal(got, expect)


def _seeded_columns(seed):
    rng = np.random.default_rng(seed)
    strs = np.empty(5, dtype=object)
    strs[:] = [f"row-{int(i)}" for i in rng.integers(0, 1000, 5)]
    ragged = np.empty(5, dtype=object)
    ragged[:] = [rng.integers(0, 9, int(n)).astype(np.int32) for n in rng.integers(1, 6, 5)]
    return {"label": rng.integers(0, 1000, 5).astype(np.int64),
            "image": rng.integers(0, 256, (5, 8, 6, 3)).astype(np.uint8),
            "coef": rng.integers(-512, 512, (5, 4, 64)).astype(np.int16),
            "weight": rng.standard_normal(5).astype(np.float32),
            "name": strs, "tokens": ragged,
            "transposed": np.ascontiguousarray(rng.standard_normal((3, 5))).T}


@pytest.mark.parametrize("codec", ["", "zlib"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_frames_are_the_jax_bytes(seed, codec):
    cols = _seeded_columns(seed)
    frames = []
    for pkg in (jax_batch, batch):
        header, parts = PKGS["jax" if pkg is jax_batch else "torch"].wire.encode_batch_parts(
            pkg.ColumnBatch(dict(cols), 5, ordinal=11), codec=codec)
        frames.append((jax_wire.dumps(header), b"".join(bytes(p) for p in parts)))
    assert frames[0] == frames[1]


@pytest.mark.parametrize("codec", ["", "zlib"])
@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=lambda d: d)
def test_batch_frames_cross_decode(src, dst, codec):
    cols = _seeded_columns(3)
    header, parts = PKGS[src].wire.encode_batch_parts(
        PKGS[src].batch.ColumnBatch(dict(cols), 5, ordinal=4), codec=codec)
    body = bytearray(b"".join(bytes(p) for p in parts))
    out = PKGS[dst].wire.decode_batch_body(header, memoryview(body))
    assert isinstance(out, PKGS[dst].batch.ColumnBatch)
    assert out.num_rows == 5 and out.ordinal == 4 and list(out.columns) == list(cols)
    for name, col in cols.items():
        if col.dtype == object:
            for a, b in zip(out.columns[name], col):
                assert np.array_equal(a, b)
        else:
            assert out.columns[name].dtype == col.dtype
            assert np.array_equal(out.columns[name], col)
            assert out.columns[name].flags.writeable


@pytest.mark.parametrize("kind", ["batch", "pickle"])
def test_encode_result_is_the_jax_payload(kind):
    outs = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        value = (p.batch.ColumnBatch(_seeded_columns(5), 5) if kind == "batch"
                 else ("echo", "payload", 3))
        header, parts = p.protocol.encode_result(value, arena=None)
        outs.append((jax_wire.dumps(header), b"".join(bytes(x) for x in parts)))
    assert outs[0] == outs[1]


def _work_items():
    rg = types.SimpleNamespace(path="/data/part-0.parquet", row_group=7)
    return {"plain": (3, ("work", 1), 1), "rowgroup": (0, types.SimpleNamespace(row_group=rg), 0)}


@pytest.mark.parametrize("trace_id", [None, 48])
@pytest.mark.parametrize("which", ["plain", "rowgroup"])
def test_wire_items_are_the_jax_bytes(which, trace_id):
    ordinal, work, attempt = _work_items()[which]
    enc = [PKGS[n].protocol.WireItem.encode(PKGS[n].pool.VentilatedItem(ordinal, work, attempt),
                                            trace_id=trace_id)
           for n in ("jax", "torch")]
    assert jax_wire.dumps(enc[0]) == wire.dumps(enc[1])
    for n in ("jax", "torch"):  # and each package's dispatcher view reads the other's
        item = PKGS[n].protocol.WireItem.from_wire(enc[1] if n == "jax" else enc[0])
        assert (item.ordinal, item.attempt, item.rg) == (
            ordinal, attempt, enc[0].get("rg"))
        assert item.tc == (None if trace_id is None else {"id": trace_id, "hops": []})
        assert pickle.loads(item.blob) == work


@pytest.mark.parametrize("src,dst", DIRECTIONS, ids=lambda d: d)
def test_frame_sockets_speak_to_each_other(src, dst):
    a, b = socket.socketpair()
    fa, fb = PKGS[src].protocol.FrameSocket(a), PKGS[dst].protocol.FrameSocket(b)
    try:
        msgs = [{"t": "x", "n": 1}, {"t": "y", "blob": os.urandom(1 << 16)}]
        for m in msgs:
            fa.send(m)
        got = [fb.recv(timeout=5.0) for _ in msgs]
        assert got == msgs
        col = np.arange(24, dtype=np.float64).reshape(4, 6)
        header, parts = PKGS[src].protocol.encode_result(
            PKGS[src].batch.ColumnBatch({"v": col}, 4))
        fa.send_batch(dict(header, t="result", ordinal=2), parts)
        msg = fb.recv(timeout=5.0)
        out = PKGS[dst].protocol.PayloadDecoder().decode(msg)
        assert msg["ordinal"] == 2 and np.array_equal(out.columns["v"], col)
        assert fb.bytes_received == fa.bytes_sent
    finally:
        fa.close()
        fb.close()


# -- hello frames ----------------------------------------------------------------------------

_FACTORY = functools.partial(eval, "lambda item: item")


def _capture_first_frame(reply: dict):
    """A one-shot listener: records the first raw frame a peer sends and
    answers ``reply`` (then closes)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10.0)
    got = {}

    def serve():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        with conn:
            conn.settimeout(10.0)
            raw = b""
            while len(raw) < 4:
                raw += conn.recv(4 - len(raw))
            (length,) = struct.unpack("!I", raw)
            body = b""
            while len(body) < length:
                body += conn.recv(length - len(body))
            got["frame"] = raw + body
            payload = bytes([jax_wire.KIND_CTRL]) + jax_wire.dumps(reply)
            conn.sendall(struct.pack("!I", len(payload)) + payload)
            conn.recv(1)  # until the peer hangs up (bounded by the timeout)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv, t, got


def test_client_hello_is_the_jax_frame(monkeypatch):
    monkeypatch.setenv("PETASTORM_TPU_SERVICE_TOKEN", "tok")
    frames = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        srv, t, got = _capture_first_frame({"t": "hello_ok", "boot": "b0", "epoch": 1})
        try:
            ex = p.client.ServiceExecutor(f"127.0.0.1:{srv.getsockname()[1]}",
                                          telemetry=p.Telemetry(), client_id="c-fixed",
                                          weight=2.0, priority=1)
            ex._factory_blob = pickle.dumps(_FACTORY, protocol=pickle.HIGHEST_PROTOCOL)  # noqa: SLF001
            ex._connect(resume=False)  # noqa: SLF001
            ex._conn.close()  # noqa: SLF001
            t.join(timeout=10.0)
        finally:
            srv.close()
        frames.append(got["frame"])
    msgs = [jax_protocol.FrameSocket._parse(f[4:]) for f in frames]  # noqa: SLF001
    # the shm capability is each package's own probe of its arena library
    assert msgs[0].pop("shm_ok") is True and msgs[1].pop("shm_ok") is True
    assert msgs[0] == msgs[1]
    assert msgs[1]["client"] == "c-fixed" and msgs[1]["token"] == "tok"


def test_worker_hello_is_the_jax_frame():
    frames = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        srv, t, got = _capture_first_frame({"t": "hello_ok", "worker": "w0", "epoch": 0})
        try:
            w = p.worker.ServiceWorker(f"127.0.0.1:{srv.getsockname()[1]}", capacity=3,
                                       name="w0", auth_token="s3cret")
            conn = p.protocol.connect_frames(("127.0.0.1", srv.getsockname()[1]))
            w._register(conn)  # noqa: SLF001
            conn.close()
            t.join(timeout=10.0)
        finally:
            srv.close()
        frames.append(got["frame"])
    assert frames[0] == frames[1]


# -- errors ----------------------------------------------------------------------------------

def _bad_inputs():
    good = jax_wire.dumps({"k": [1, 2, 3]})
    return {
        "truncated": lambda w: w.loads(good[:-2]),
        "trailing": lambda w: w.loads(good + b"\x00"),
        "list_bomb": lambda w: w.loads(struct.pack("!BI", 0x07, (1 << 20) + 1)),
        "objarray_bomb": lambda w: w.loads(struct.pack("!BBI", 0x0A, 1, 1 << 29)),
        "deep": lambda w: w.loads(b"\x07\x00\x00\x00\x01" * 64 + jax_wire.dumps(None)),
        "unknown_tag": lambda w: w.loads(b"\x55"),
        "object_dtype": lambda w: w.loads(b"\x09\x02|O\x01\x00\x00\x00\x01\x00\x00\x00\x08"
                                          + b"\x00" * 8),
        "bad_utf8": lambda w: w.loads(b"\x05\x00\x00\x00\x01\xff"),
        "unencodable": lambda w: w.dumps(object()),
        "int_overflow": lambda w: w.dumps(2 ** 70),
        "non_str_key": lambda w: w.dumps({1: 2}),
    }


def _batch_specs():
    return {
        "short_nbytes": ({"x": ["raw", "<i8", [10], 0, 64]}, 10, None),
        "overrun": ({"x": ["raw", "<i8", [10], 64, 80]}, 10, None),
        "object_dtype": ({"x": ["raw", "|O", [10], 0, 80]}, 10, None),
        "bad_dtype": ({"x": ["raw", "not-a-dtype", [10], 0, 80]}, 10, None),
        "rows": ({"x": ["raw", "<i8", [10], 0, 80]}, 7, None),
        "blen": ({"x": ["raw", "<i8", [10], 0, 80]}, 10, 79),
        "huge": ({"x": ["raw", "<i8", [1 << 30, 1 << 30], 0, 80]}, 10, None),
        "oversize_table": ({f"c{i}": ["inline", None] for i in range(5000)}, 10, None),
        "unknown_kind": ({"x": ["mystery", 1]}, 10, None),
        "short_spec": ({"x": ["raw", "<i8"]}, 10, None),
    }


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the outcome under test
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_malformed_control_input_raises_the_jax_error(case):
    fn = _bad_inputs()[case]
    jax_out, out = _raised(lambda: fn(jax_wire)), _raised(lambda: fn(wire))
    assert out is not None and out == jax_out


@pytest.mark.parametrize("case", sorted(_batch_specs()))
def test_malformed_batch_frame_raises_the_jax_error(case):
    cols, rows, blen = _batch_specs()[case]
    body = bytearray(np.arange(10, dtype=np.int64).tobytes())
    header = {"pk": "bin", "rows": rows, "cols": cols,
              "blen": len(body) if blen is None else blen, "codec": ""}
    outs = [_raised(lambda w=w: w.decode_batch_body(header, memoryview(body)))
            for w in (jax_wire, wire)]
    assert outs[1] is not None and outs[1] == outs[0]
    assert outs[1][0] == "WireFormatError"


@pytest.mark.parametrize("frame", ["unknown_kind", "legacy_v1", "empty", "short_batch",
                                   "batch_header_overrun"])
def test_malformed_frames_raise_the_jax_error_and_keep_the_stream(frame):
    payload = {"unknown_kind": b"\x7f",
               "legacy_v1": pickle.dumps({"t": "client_hello", "protocol": 1}),
               "empty": b"",
               "short_batch": b"\x02\x00",
               "batch_header_overrun": b"\x02\x00\x00\x01\x00"}[frame]
    outs = []
    for name in ("jax", "torch"):
        a, b = socket.socketpair()
        fb = PKGS[name].protocol.FrameSocket(b)
        try:
            a.sendall(struct.pack("!I", len(payload)) + payload)
            outs.append(_raised(lambda: fb.recv(timeout=5.0)))
            # the stream stays synced: a good frame after the bad one parses
            good = bytes([jax_wire.KIND_CTRL]) + jax_wire.dumps({"t": "ok"})
            a.sendall(struct.pack("!I", len(good)) + good)
            assert fb.recv(timeout=5.0) == {"t": "ok"}
        finally:
            a.close()
            fb.close()
    assert outs[1] is not None and outs[1] == outs[0]


def test_a_legacy_v1_client_is_refused_as_by_jax():
    replies = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry()).start()
        try:
            sock = socket.create_connection(("127.0.0.1", disp.port), timeout=5)
            sock.settimeout(5.0)
            evil = pickle.dumps({"t": "client_hello", "protocol": 1})
            sock.sendall(struct.pack("!I", len(evil)) + evil)
            raw = b""
            while True:
                chunk = sock.recv(1 << 16)
                if not chunk:
                    break
                raw += chunk
            sock.close()
        finally:
            disp.stop()
            disp.join()
        (length,) = struct.unpack("!I", raw[:4])
        replies.append(pickle.loads(raw[4:4 + length]))
    assert replies[0] == replies[1] and "protocol version mismatch" in replies[1]["error"]


@pytest.mark.parametrize("refuse", [False, True])
def test_pickle_payload_gate_as_in_jax(refuse):
    header, parts = protocol.encode_result(("echo", "payload", 3))
    msg = dict(header, _body=memoryview(bytearray(b"".join(parts))))
    outs = [_raised(lambda p=p: p.PayloadDecoder(allow_pickle=not refuse).decode(msg))
            for p in (jax_protocol, protocol)]
    assert outs[0] == outs[1]
    if refuse:
        assert outs[1][0] == "WireFormatError" and "refuses" in outs[1][1]
    else:
        assert protocol.PayloadDecoder().decode(msg) == ("echo", "payload", 3)


# -- decisions -------------------------------------------------------------------------------

@pytest.mark.parametrize("preference", ["auto", "off", "zlib", "lz4"])
@pytest.mark.parametrize("same_host", [True, False])
@pytest.mark.parametrize("client_codecs", [(), ("zlib",), ("zlib", "lz4")])
@pytest.mark.parametrize("worker_codecs", [(), ("zlib",)])
def test_negotiate_codec_as_in_jax(preference, same_host, client_codecs, worker_codecs):
    args = (preference, same_host, client_codecs, worker_codecs)
    assert wire.negotiate_codec(*args) == jax_wire.negotiate_codec(*args)
    assert wire.SUPPORTED_CODECS == jax_wire.SUPPORTED_CODECS
    assert wire.WIRE_VERSION == jax_wire.WIRE_VERSION == 2


@pytest.mark.parametrize("address", ["host:123", ("h", 9), ":123", "no-port", "a:1,b:2",
                                     " a:1 , b:2 ,", ",", ["x", "7"], "[::1]:80", 5])
def test_parse_address_as_in_jax(address):
    for fn in ("parse_address", "parse_address_list"):
        outs = [_raised(lambda p=p: getattr(p, fn)(address)) for p in (jax_protocol, protocol)]
        if outs[0] is None:
            assert getattr(protocol, fn)(address) == getattr(jax_protocol, fn)(address)
        else:
            assert outs[1] == outs[0]


@pytest.mark.parametrize("expected", [None, "s3cret"])
@pytest.mark.parametrize("presented", [None, "s3cret", "nope", 7, ""])
def test_auth_check_as_in_jax(expected, presented):
    assert protocol.token_matches(expected, presented) == jax_protocol.token_matches(
        expected, presented)


@pytest.mark.parametrize("env", [None, "", "tok"])
@pytest.mark.parametrize("explicit", [None, "x"])
def test_auth_and_pickle_knobs_resolve_as_in_jax(env, explicit, monkeypatch):
    for var in ("PETASTORM_TPU_SERVICE_TOKEN", "PETASTORM_TPU_SERVICE_ALLOW_PICKLE"):
        if env is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, env)
    assert protocol.resolve_auth_token(explicit) == jax_protocol.resolve_auth_token(explicit)
    flag = None if explicit is None else False
    assert protocol.resolve_allow_pickle(flag) == jax_protocol.resolve_allow_pickle(flag)
    assert protocol.AUTH_TOKEN_ENV == jax_protocol.AUTH_TOKEN_ENV
    assert protocol.ALLOW_PICKLE_ENV == jax_protocol.ALLOW_PICKLE_ENV


def test_auth_token_gates_every_hello():
    disp = dispatcher.Dispatcher(telemetry=Telemetry(), auth_token="s3cret").start()
    addr = f"127.0.0.1:{disp.port}"
    try:
        assert service_worker.ServiceWorker(addr, capacity=1, auth_token=None).run() == 1
        ex = client.ServiceExecutor(addr, telemetry=Telemetry(), auth_token="nope")
        with pytest.raises(OSError, match="refused"):
            ex.start(_FACTORY)
        probe = protocol.connect_frames(protocol.parse_address(addr))
        probe.send({"t": "stats?"})
        assert probe.recv(timeout=5.0)["t"] == "error"
        probe.close()
        assert disp.stats()["counters"].get("service.auth_rejected", 0) >= 3
    finally:
        disp.stop()
        disp.join()


@pytest.mark.parametrize("n_workers", [1, 3, 5])
def test_worker_affinity_pick_as_in_jax(n_workers):
    rng = np.random.default_rng(n_workers)
    picks = []
    for name in ("jax", "torch"):
        p = PKGS[name]
        a, b = socket.socketpair()
        conn = p.protocol.FrameSocket(a)
        disp = p.dispatcher.Dispatcher(telemetry=p.Telemetry())  # never started
        workers = {f"w{i}": p.dispatcher._WorkerState(f"w{i}", conn, 2, "h")  # noqa: SLF001
                   for i in range(n_workers)}
        disp._workers = workers  # noqa: SLF001
        out = []
        for k in range(40):
            rg = [f"/data/part-{int(rng.integers(0, 9))}.parquet", int(rng.integers(0, 99))]
            item = p.protocol.WireItem(k, 0, b"opaque", rg)
            free = list(workers.values())
            if k % 3 == 0 and n_workers > 1:
                free = free[1:]  # the affine worker may be saturated
            if k % 5 == 0:
                free[0].inflight.add(("c", k))  # load churn
            out.append(disp._pick_worker(item, free).name)  # noqa: SLF001
        picks.append(out)
        conn.close()
        b.close()
        rng = np.random.default_rng(n_workers)
    assert picks[0] == picks[1]
