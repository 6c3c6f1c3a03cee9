"""The port's HDFS namenode HA (``petastorm_tpu_torch/hdfs.py``) against the
JAX package's, with mocked connectors: no HDFS anywhere.

The JAX suite's cases (``tests/test_hdfs.py``) on the port's module, and the
resolver's and the configuration loader's answers held equal to the JAX
module's on the same inputs.
"""

import pickle

import pytest

from petastorm_tpu import hdfs as jax_hdfs
from petastorm_tpu_torch import hdfs as hdfs_ha
from petastorm_tpu_torch.hdfs import (HdfsConnectError, HdfsConnector,
                                HdfsNamenodeResolver, MaxFailoversExceeded,
                                connect_to_either_namenode,
                                load_hadoop_configuration)

HA_CONFIG = {
    "fs.defaultFS": "hdfs://nameservice1",
    "dfs.ha.namenodes.nameservice1": "nn1,nn2",
    "dfs.namenode.rpc-address.nameservice1.nn1": "host-a:8020",
    "dfs.namenode.rpc-address.nameservice1.nn2": "host-b:8020",
}


# ---------------------------------------------------------------------------
# Mock connector / filesystem
# ---------------------------------------------------------------------------

class MockHdfs:
    """Stands in for pyarrow's HadoopFileSystem: fails its calls a programmed
    number of times with OSError (what a standby namenode raises).  Answers
    ``get_file_info`` with real ``pyarrow.fs.FileInfo`` whose path is prefixed
    by the answering host, so tests can see which namenode served the call."""

    def __init__(self, host, fail_calls=0):
        self.host = host
        self._fail_calls = fail_calls

    def get_file_info(self, paths):
        import pyarrow.fs as pafs

        if self._fail_calls > 0:
            self._fail_calls -= 1
            raise OSError(f"standby namenode {self.host}")
        if isinstance(paths, (list, tuple)):
            return [pafs.FileInfo(f"{self.host}:{p}", type=pafs.FileType.File)
                    for p in paths]
        return [pafs.FileInfo(f"{self.host}:{paths}", type=pafs.FileType.File)]


class MockConnector(HdfsConnector):
    """Programmable per-host behavior: hosts in ``down`` refuse connections;
    ``fail_first_calls`` makes each connected fs fail that many calls."""

    down = set()
    fail_first_calls = {}
    connect_attempts = []

    @classmethod
    def reset(cls, down=(), fail_first_calls=None):
        cls.down = set(down)
        cls.fail_first_calls = dict(fail_first_calls or {})
        cls.connect_attempts = []

    @classmethod
    def connect_namenode(cls, host, port, user=None):
        cls.connect_attempts.append(f"{host}:{port}")
        if host in cls.down:
            raise OSError(f"connection refused: {host}")
        return MockHdfs(host, fail_calls=cls.fail_first_calls.get(host, 0))


# ---------------------------------------------------------------------------
# Resolver
# ---------------------------------------------------------------------------

def test_resolve_nameservice():
    r = HdfsNamenodeResolver(HA_CONFIG)
    assert r.resolve_hdfs_name_service("nameservice1") == ["host-a:8020", "host-b:8020"]


def test_resolve_plain_hostname_returns_none():
    r = HdfsNamenodeResolver(HA_CONFIG)
    assert r.resolve_hdfs_name_service("some-host.example.com") is None


def test_resolve_default_service():
    r = HdfsNamenodeResolver(HA_CONFIG)
    ns, nns = r.resolve_default_hdfs_service()
    assert ns == "nameservice1" and nns == ["host-a:8020", "host-b:8020"]


def test_missing_rpc_address_raises():
    cfg = dict(HA_CONFIG)
    del cfg["dfs.namenode.rpc-address.nameservice1.nn2"]
    with pytest.raises(RuntimeError, match="rpc-address.nameservice1.nn2"):
        HdfsNamenodeResolver(cfg).resolve_hdfs_name_service("nameservice1")


def test_missing_default_fs_raises():
    with pytest.raises(RuntimeError, match="fs.defaultFS"):
        HdfsNamenodeResolver({}).resolve_default_hdfs_service()


def test_default_fs_without_ha_config_raises():
    with pytest.raises(IOError, match="namenodes for default service"):
        HdfsNamenodeResolver({"fs.defaultFS": "hdfs://ns"}).resolve_default_hdfs_service()


def test_load_hadoop_configuration_from_xml(tmp_path, monkeypatch):
    conf = tmp_path / "hadoop-conf"
    conf.mkdir()
    (conf / "hdfs-site.xml").write_text(
        "<configuration>"
        "<property><name>dfs.ha.namenodes.ns</name><value>a,b</value></property>"
        "<property><name>dfs.namenode.rpc-address.ns.a</name><value>h1:8020</value></property>"
        "<property><name>dfs.namenode.rpc-address.ns.b</name><value>h2:8020</value></property>"
        "</configuration>")
    (conf / "core-site.xml").write_text(
        "<configuration>"
        "<property><name>fs.defaultFS</name><value>hdfs://ns</value></property>"
        "</configuration>")
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf))
    cfg = load_hadoop_configuration()
    r = HdfsNamenodeResolver(cfg)
    assert r.resolve_default_hdfs_service() == ("ns", ["h1:8020", "h2:8020"])


def test_load_hadoop_configuration_hadoop_home(tmp_path, monkeypatch):
    home = tmp_path / "hadoop"
    conf = home / "etc" / "hadoop"
    conf.mkdir(parents=True)
    (conf / "core-site.xml").write_text(
        "<configuration><property><name>k</name><value>v</value></property></configuration>")
    monkeypatch.delenv("HADOOP_CONF_DIR", raising=False)
    monkeypatch.setenv("HADOOP_HOME", str(home))
    assert load_hadoop_configuration()["k"] == "v"


def test_load_hadoop_configuration_unset_env(monkeypatch):
    for env in ("HADOOP_CONF_DIR", "HADOOP_HOME", "HADOOP_PREFIX", "HADOOP_INSTALL"):
        monkeypatch.delenv(env, raising=False)
    assert load_hadoop_configuration() == {}


# ---------------------------------------------------------------------------
# HA client failover
# ---------------------------------------------------------------------------

NAMENODES = ["host-a:8020", "host-b:8020"]


def test_connects_to_first_available():
    MockConnector.reset()
    fs = connect_to_either_namenode(NAMENODES, connector_cls=MockConnector)
    assert MockConnector.connect_attempts == ["host-a:8020"]
    assert fs.get_file_info("/x").path == "host-a:/x"


def test_failover_to_second_namenode_on_connect():
    MockConnector.reset(down={"host-a"})
    fs = connect_to_either_namenode(NAMENODES, connector_cls=MockConnector)
    assert MockConnector.connect_attempts == ["host-a:8020", "host-b:8020"]
    assert fs.get_file_info("/x").path == "host-b:/x"


def test_both_down_raises_connect_error():
    MockConnector.reset(down={"host-a", "host-b"})
    with pytest.raises(HdfsConnectError, match="Unable to connect"):
        connect_to_either_namenode(NAMENODES, connector_cls=MockConnector)


def test_call_failover_reconnects_to_other_namenode():
    # host-a accepts the connection but fails its first call (standby behavior);
    # the call must transparently retry against host-b
    MockConnector.reset(fail_first_calls={"host-a": 1})
    fs = connect_to_either_namenode(NAMENODES, connector_cls=MockConnector)
    assert fs.get_file_info("/x").path == "host-b:/x"
    assert MockConnector.connect_attempts == ["host-a:8020", "host-b:8020"]


def test_max_failovers_exceeded():
    MockConnector.reset(fail_first_calls={"host-a": 99, "host-b": 99})
    fs = connect_to_either_namenode(NAMENODES, connector_cls=MockConnector)
    with pytest.raises(Exception) as exc_info:
        fs.get_file_info("/x")
    # pyarrow surfaces the python exception from the handler; the root cause
    # must be the failover budget, with the per-attempt errors recorded
    assert "Failover attempts exceeded" in str(exc_info.value)


def test_too_many_namenodes_rejected():
    with pytest.raises(ValueError, match="1..2"):
        connect_to_either_namenode(["a", "b", "c"], connector_cls=MockConnector)
    with pytest.raises(ValueError):
        connect_to_either_namenode([], connector_cls=MockConnector)


def test_handler_picklable():
    """Worker processes must be able to receive the resolved filesystem
    (reference pickles HAHdfsClient, hdfs/namenode.py:232-235)."""
    MockConnector.reset()
    handler = hdfs_ha._HaFilesystemHandler(MockConnector, NAMENODES, user=None)
    clone = pickle.loads(pickle.dumps(handler))
    assert clone._namenodes == NAMENODES
    assert clone.get_file_info(["/y"])[0].path == "host-a:/y"


# ---------------------------------------------------------------------------
# URL-level resolution
# ---------------------------------------------------------------------------

def test_resolve_and_connect_nameservice_url():
    MockConnector.reset(down={"host-a"})
    fs, path = hdfs_ha.resolve_and_connect(
        "hdfs://nameservice1/data/set", hadoop_configuration=HA_CONFIG,
        connector_cls=MockConnector)
    assert path == "/data/set"
    assert fs.get_file_info("/data/set").path == "host-b:/data/set"


def test_resolve_and_connect_plain_host():
    MockConnector.reset()
    fs, path = hdfs_ha.resolve_and_connect(
        "hdfs://plainhost:9000/data", hadoop_configuration=HA_CONFIG,
        connector_cls=MockConnector)
    assert path == "/data"
    assert MockConnector.connect_attempts == ["plainhost:9000"]


def test_non_transient_errors_bypass_failover():
    """FileNotFoundError et al. describe the file, not the connection - they
    must surface unchanged (no reconnects) so `except FileNotFoundError`
    callers keep working."""
    class _FnfFs:
        def delete_dir(self, path):
            raise FileNotFoundError(path)

    class _FnfConnector(HdfsConnector):
        connects = 0

        @classmethod
        def connect_namenode(cls, host, port, user=None):
            cls.connects += 1
            return _FnfFs()

    handler = hdfs_ha._HaFilesystemHandler(_FnfConnector, ["host-a:8020"], None)
    with pytest.raises(FileNotFoundError):
        handler.delete_dir("/gone")
    assert _FnfConnector.connects == 1  # no failover reconnects


def test_hdfs_url_list_paths_drop_authority():
    """Every URL in an hdfs:// list must resolve to the same path convention
    (the authority is a host/nameservice, never a path prefix)."""
    from petastorm_tpu_torch.fs import get_filesystem_and_path

    sentinel_fs = object()
    _, p = get_filesystem_and_path("hdfs://ns1/data/a.parquet", filesystem=sentinel_fs)
    assert p == "/data/a.parquet"
    # bucket stores keep the bucket prefix
    _, p = get_filesystem_and_path("s3://bucket/data/a.parquet", filesystem=sentinel_fs)
    assert p == "bucket/data/a.parquet"


def test_resolve_url_namenodes_shared_rule():
    assert hdfs_ha.resolve_url_namenodes(
        "hdfs://nameservice1/x", HA_CONFIG) == ["host-a:8020", "host-b:8020"]
    assert hdfs_ha.resolve_url_namenodes("hdfs://plain:9000/x", HA_CONFIG) is None
    assert hdfs_ha.resolve_url_namenodes("hdfs:///x", {}) is None


def test_fs_resolution_uses_ha_client(monkeypatch):
    """fs.get_filesystem_and_path routes configured nameservices through the
    failover client and PROPAGATES an all-namenodes-down outage."""
    from petastorm_tpu_torch import fs as fs_mod

    monkeypatch.setattr(hdfs_ha, "load_hadoop_configuration", lambda: dict(HA_CONFIG))
    monkeypatch.setattr(hdfs_ha, "HdfsConnector", MockConnector)
    MockConnector.reset(down={"host-a"})
    fs, path = fs_mod.get_filesystem_and_path("hdfs://nameservice1/data")
    assert path == "/data"
    assert fs.get_file_info("/data").path == "host-b:/data"
    MockConnector.reset(down={"host-a", "host-b"})
    with pytest.raises(HdfsConnectError):
        fs_mod.get_filesystem_and_path("hdfs://nameservice1/data")


def test_resolve_and_connect_default_service():
    MockConnector.reset()
    fs, path = hdfs_ha.resolve_and_connect(
        "hdfs:///data", hadoop_configuration=HA_CONFIG,
        connector_cls=MockConnector)
    assert path == "/data"
    assert fs.get_file_info("/data").path == "host-a:/data"


# ---------------------------------------------------------------------------
# Parity with the JAX module
# ---------------------------------------------------------------------------

_CONFIGS = [HA_CONFIG, {"fs.defaultFS": "hdfs://ns"}, {},
            dict(HA_CONFIG, **{"dfs.ha.namenodes.other": "x",
                               "dfs.namenode.rpc-address.other.x": "h9:1"})]
_URLS = ["hdfs://nameservice1/x", "hdfs://plain:9000/x", "hdfs:///x", "hdfs://other/y/z",
         "hdfs://nameservice1", "hdfs://unknown-ns/data"]


@pytest.mark.parametrize("config", range(len(_CONFIGS)))
def test_resolver_answers_equal_the_jax_modules(config):
    cfg = _CONFIGS[config]

    def answers(mod):
        out = []
        for url in _URLS:
            try:
                out.append(("ok", mod.resolve_url_namenodes(url, cfg)))
            except Exception as exc:  # noqa: BLE001 - compared by type and text
                out.append((type(exc).__name__, str(exc)))
        for call in (lambda r: r.resolve_default_hdfs_service(),
                     lambda r: r.resolve_hdfs_name_service("nameservice1"),
                     lambda r: r.resolve_hdfs_name_service("other")):
            try:
                out.append(("ok", call(mod.HdfsNamenodeResolver(cfg))))
            except Exception as exc:  # noqa: BLE001
                out.append((type(exc).__name__, str(exc)))
        return out

    assert answers(hdfs_ha) == answers(jax_hdfs)


def test_configuration_loader_equals_the_jax_modules(tmp_path, monkeypatch):
    conf = tmp_path / "conf"
    conf.mkdir()
    (conf / "hdfs-site.xml").write_text(
        "<configuration>"
        "<property><name>dfs.ha.namenodes.ns</name><value>a,b</value></property>"
        "<property><name>dfs.namenode.rpc-address.ns.a</name><value>h1:8020</value></property>"
        "<property><name>broken</name></property>"
        "</configuration>")
    (conf / "core-site.xml").write_text("<configuration><property>")  # unparseable
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf))
    assert hdfs_ha.load_hadoop_configuration() == jax_hdfs.load_hadoop_configuration()
