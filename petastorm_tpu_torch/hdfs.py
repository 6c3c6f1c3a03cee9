"""HDFS namenode high availability: nameservice resolution and a failover client.

Counterpart of ``petastorm_tpu/hdfs.py``, whole: the site-XML configuration
(``HADOOP_CONF_DIR``, then the ``HADOOP_HOME``-style install roots),
``HdfsNamenodeResolver`` (nameservices to namenode addresses),
``HdfsConnector`` (round-robin connect), the failover client
(``_HaFilesystemHandler``: every filesystem call through one gate that
reconnects to the other namenode, at most ``MAX_FAILOVER_ATTEMPTS`` times,
then ``MaxFailoversExceeded``), wrapped in ``pyarrow.fs.PyFileSystem`` so it
is a real ``pyarrow.fs.FileSystem``, and ``connect_to_either_namenode`` /
``resolve_and_connect``, which ``fs.get_filesystem_and_path`` calls for an
``hdfs://`` URL whose authority is a configured nameservice.
"""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

import pyarrow.fs as pafs

logger = logging.getLogger(__name__)

#: HDFS HA supports at most 2 namenodes per nameservice (same bound as the
#: reference, hdfs/namenode.py:248).
MAX_NAMENODES = 2
#: Re-connect/retry budget per filesystem call (reference hdfs/namenode.py:152).
MAX_FAILOVER_ATTEMPTS = 2


class HdfsConnectError(IOError):
    """No namenode in the list accepted a connection."""


class MaxFailoversExceeded(RuntimeError):
    """A filesystem call kept failing across reconnect attempts."""

    def __init__(self, failed_exceptions, max_failover_attempts, func_name):
        self.failed_exceptions = failed_exceptions
        self.max_failover_attempts = max_failover_attempts
        self.func_name = func_name
        super().__init__(
            f"Failover attempts exceeded maximum ({max_failover_attempts}) for"
            f" action {func_name!r}. Exceptions:\n{failed_exceptions}")


def _load_site_xml(xml_path: str, into: Dict[str, str]) -> None:
    try:
        for prop in ET.parse(xml_path).getroot().iter("property"):
            name, value = prop.find("name"), prop.find("value")
            if name is not None and value is not None and name.text:
                into[name.text] = value.text or ""
    except ET.ParseError as exc:
        logger.error("Unparseable hadoop site XML %s: %s", xml_path, exc)
    except OSError:
        pass  # absent file: fine, sites are optional


_CONFIG_CACHE: Dict[str, Dict[str, str]] = {}


def load_hadoop_configuration(conf_dir: Optional[str] = None) -> Dict[str, str]:
    """Flat dict of hadoop properties from ``{conf_dir}/{hdfs,core}-site.xml``.

    When ``conf_dir`` is None, checks ``HADOOP_CONF_DIR`` first, then the
    ``etc/hadoop`` of ``HADOOP_HOME``/``HADOOP_PREFIX``/``HADOOP_INSTALL``
    (reference env order at hdfs/namenode.py:44-57).  Parsed configs are cached
    per directory - URL resolution runs this on every ``hdfs://`` dataset open
    and in every worker process.
    """
    if conf_dir is None:
        if "HADOOP_CONF_DIR" in os.environ:
            conf_dir = os.environ["HADOOP_CONF_DIR"]
        else:
            for env in ("HADOOP_HOME", "HADOOP_PREFIX", "HADOOP_INSTALL"):
                if env in os.environ:
                    conf_dir = os.path.join(os.environ[env], "etc", "hadoop")
                    break
    if conf_dir is None:
        # a valid setup: pyarrow's libhdfs reads the cluster config itself, so
        # URL resolution falls through to it (debug, not warning - this runs on
        # every hdfs:// open)
        logger.debug(
            "No HADOOP_CONF_DIR/HADOOP_HOME set; python-level namenode HA"
            " resolution disabled")
        return {}
    cached = _CONFIG_CACHE.get(conf_dir)
    if cached is None:
        cached = {}
        _load_site_xml(os.path.join(conf_dir, "hdfs-site.xml"), cached)
        _load_site_xml(os.path.join(conf_dir, "core-site.xml"), cached)
        _CONFIG_CACHE[conf_dir] = cached
    return dict(cached)


class HdfsNamenodeResolver:
    """Resolves HDFS namenodes for a logical nameservice from hadoop config.

    Reference: hdfs/namenode.py:31-129.
    """

    def __init__(self, hadoop_configuration: Optional[Dict[str, str]] = None):
        if hadoop_configuration is None:
            hadoop_configuration = load_hadoop_configuration()
        self._config = hadoop_configuration

    def resolve_hdfs_name_service(self, nameservice: str) -> Optional[List[str]]:
        """``['host1:8020', 'host2:8020']`` for a configured nameservice, else
        None (the authority may simply be a plain hostname - reference
        hdfs/namenode.py:108-110)."""
        namenodes = self._config.get("dfs.ha.namenodes." + nameservice)
        if not namenodes:
            return None
        out = []
        for nn in namenodes.split(","):
            key = f"dfs.namenode.rpc-address.{nameservice}.{nn.strip()}"
            addr = self._config.get(key)
            if not addr:
                raise RuntimeError(
                    f"Failed to get property {key!r} from the hadoop"
                    " configuration; check your hdfs-site.xml")
            out.append(addr)
        return out

    def resolve_default_hdfs_service(self) -> Tuple[str, List[str]]:
        """(nameservice, namenode list) from ``fs.defaultFS``."""
        default_fs = self._config.get("fs.defaultFS")
        if not default_fs:
            raise RuntimeError(
                "Failed to get property 'fs.defaultFS' from the hadoop"
                " configuration; check your core-site.xml")
        nameservice = urlparse(default_fs).netloc
        namenodes = self.resolve_hdfs_name_service(nameservice)
        if namenodes is None:
            raise IOError(
                f"Unable to get namenodes for default service {default_fs!r}"
                " from the hadoop configuration")
        return nameservice, namenodes


class HdfsConnector:
    """Owns the actual connect call; swap/mock point for tests (reference
    hdfs/namenode.py:244-262)."""

    @classmethod
    def connect_namenode(cls, host: str, port: int, user: Optional[str] = None):
        return pafs.HadoopFileSystem(host=host, port=port, user=user)

    @classmethod
    def try_next_namenode(cls, index_of_nn: int, namenodes: List[str],
                          user: Optional[str] = None) -> Tuple[int, object]:
        """Round-robin connect starting AFTER ``index_of_nn`` so a retry lands
        on a different namenode (reference hdfs/namenode.py:288-313)."""
        n = len(namenodes)
        if n:
            for i in range(1, MAX_NAMENODES + 1):
                idx = (index_of_nn + i) % n
                authority = namenodes[idx]
                parsed = urlparse("hdfs://" + authority)
                try:
                    return idx, cls.connect_namenode(
                        parsed.hostname or "default", parsed.port or 8020, user)
                except OSError as exc:
                    # expected when this namenode is the standby
                    logger.debug("Namenode %s refused connection: %s",
                                 authority, exc)
        raise HdfsConnectError(
            f"Unable to connect to HDFS cluster (namenodes: {namenodes})")


class _HaFilesystemHandler(pafs.FileSystemHandler):
    """``pyarrow.fs.FileSystemHandler`` delegating every filesystem operation to
    the currently connected namenode, reconnecting to the next one and retrying
    on IO errors, up to MAX_FAILOVER_ATTEMPTS reconnects per call."""

    def __init__(self, connector_cls, namenodes: List[str], user: Optional[str]):
        self._connector_cls = connector_cls
        self._namenodes = list(namenodes)
        self._user = user
        self._index_of_nn = -1
        self._fs = None
        self._do_connect()

    def _do_connect(self) -> None:
        self._index_of_nn, self._fs = self._connector_cls.try_next_namenode(
            self._index_of_nn, self._namenodes, self._user)

    def __reduce__(self):
        # worker processes reconnect on unpickle rather than shipping a live
        # connection (reference: HAHdfsClient.__reduce__, hdfs/namenode.py:232-235)
        return self.__class__, (self._connector_cls, self._namenodes, self._user)

    #: OSError subclasses that describe the FILE, not the connection - the
    #: answer will not change on another namenode; re-raise untouched so
    #: callers' `except FileNotFoundError` etc. still match
    _NON_TRANSIENT = (FileNotFoundError, FileExistsError, PermissionError,
                      IsADirectoryError, NotADirectoryError)

    def _call(self, method: str, *args, **kwargs):
        failures = []
        while len(failures) <= MAX_FAILOVER_ATTEMPTS:
            try:
                return getattr(self._fs, method)(*args, **kwargs)
            except self._NON_TRANSIENT:
                raise
            except OSError as exc:
                failures.append(exc)
                if len(failures) <= MAX_FAILOVER_ATTEMPTS:
                    self._do_connect()
        raise MaxFailoversExceeded(failures, MAX_FAILOVER_ATTEMPTS, method)

    # -- FileSystemHandler interface ------------------------------------------

    def get_type_name(self):
        return "ha-hdfs"

    def normalize_path(self, path):
        return self._call("normalize_path", path)

    def get_file_info(self, paths):
        return self._call("get_file_info", paths)

    def get_file_info_selector(self, selector):
        return self._call("get_file_info", selector)

    def create_dir(self, path, recursive):
        self._call("create_dir", path, recursive=recursive)

    def delete_dir(self, path):
        self._call("delete_dir", path)

    def delete_dir_contents(self, path, missing_dir_ok=False):
        self._call("delete_dir_contents", path, missing_dir_ok=missing_dir_ok)

    def delete_root_dir_contents(self):
        self._call("delete_dir_contents", "/", accept_root_dir=True)

    def delete_file(self, path):
        self._call("delete_file", path)

    def move(self, src, dest):
        self._call("move", src, dest)

    def copy_file(self, src, dest):
        self._call("copy_file", src, dest)

    def open_input_stream(self, path):
        return self._call("open_input_stream", path)

    def open_input_file(self, path):
        return self._call("open_input_file", path)

    def open_output_stream(self, path, metadata):
        return self._call("open_output_stream", path, metadata=metadata)

    def open_append_stream(self, path, metadata):
        return self._call("open_append_stream", path, metadata=metadata)

    def __eq__(self, other):
        return (isinstance(other, _HaFilesystemHandler)
                and self._namenodes == other._namenodes
                and self._user == other._user)

    def __ne__(self, other):
        return not self.__eq__(other)


def connect_to_either_namenode(namenodes: List[str], user: Optional[str] = None,
                               connector_cls=None):
    """HA ``pyarrow.fs.FileSystem`` over the given namenode list.

    Reference: HdfsConnector.connect_to_either_namenode (hdfs/namenode.py:264-281).
    """
    if connector_cls is None:
        connector_cls = HdfsConnector  # late-bound so tests can swap it
    if not namenodes or len(namenodes) > MAX_NAMENODES:
        raise ValueError(
            f"Must supply 1..{MAX_NAMENODES} namenode URLs, got {namenodes!r}")
    return pafs.PyFileSystem(_HaFilesystemHandler(connector_cls, namenodes, user))


def resolve_url_namenodes(url: str,
                          hadoop_configuration: Optional[Dict[str, str]] = None,
                          ) -> Optional[List[str]]:
    """Namenode list for an ``hdfs://`` URL's authority, or None when the URL
    names no configured HA nameservice (plain host, or no hadoop config) - the
    single resolution rule shared by :func:`resolve_and_connect` and
    ``fs.get_filesystem_and_path`` so their behavior cannot drift.
    """
    parsed = urlparse(url)
    resolver = HdfsNamenodeResolver(hadoop_configuration)
    if parsed.netloc:
        return resolver.resolve_hdfs_name_service(parsed.netloc)
    try:
        return resolver.resolve_default_hdfs_service()[1]
    except (RuntimeError, IOError):
        return None  # no usable fs.defaultFS HA config


def resolve_and_connect(url: str, user: Optional[str] = None,
                        hadoop_configuration: Optional[Dict[str, str]] = None,
                        connector_cls=None):
    """``hdfs://nameservice/path`` or ``hdfs:///path`` -> (HA filesystem, path).

    Authorities that are configured HA nameservices connect through the
    failover client; a plain ``host[:port]`` authority connects directly
    (still through the reconnect gate, with a one-element namenode list).
    """
    parsed = urlparse(url)
    namenodes = resolve_url_namenodes(url, hadoop_configuration)
    if namenodes is None:
        if not parsed.netloc:
            raise RuntimeError(
                f"Cannot resolve {url!r}: no authority in the URL and no"
                " fs.defaultFS HA configuration available")
        namenodes = [parsed.netloc]
    fs = connect_to_either_namenode(namenodes, user=user,
                                    connector_cls=connector_cls)
    return fs, parsed.path
