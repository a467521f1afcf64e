"""The host side of multi-process training: the TCP record shuffle
(:mod:`.shuffle`), the host metric allreduce (:mod:`.collective`),
elastic membership over a pluggable KV store (:mod:`.elastic`) and its
network KV server (:mod:`.kv_server`). Copies of the reference's
host-only modules. The reference's launcher (``distributed/launch.py``:
``LaunchConfig``, ``init_runtime_env``, ``launch_local``, ``main``) is
not ported yet: it comes with the multi-process trainer over
``torch.distributed`` (ROADMAP queue 1 item 13, slice 3b)."""

from paddlebox_tpu_torch.distributed.collective import TcpCollective
from paddlebox_tpu_torch.distributed.elastic import (
    ElasticLevel, ElasticManager, FileKVStore, KVStore,
)
from paddlebox_tpu_torch.distributed.kv_server import KVServer, TcpKVStore
from paddlebox_tpu_torch.distributed.shuffle import (
    TcpMesh, TcpShuffler, default_route, deserialize_records,
    serialize_records,
)

__all__ = [
    "ElasticLevel", "ElasticManager", "FileKVStore", "KVStore",
    "KVServer", "TcpKVStore",
    "TcpCollective", "TcpMesh", "TcpShuffler", "default_route",
    "serialize_records", "deserialize_records",
]
