"""Multi-process training: the launcher and the process-group bootstrap
(:mod:`.launch`), the TCP record shuffle (:mod:`.shuffle`), the host
metric allreduce (:mod:`.collective`), elastic membership over a
pluggable KV store (:mod:`.elastic`) and its network KV server
(:mod:`.kv_server`). The host-only modules are copies of the
reference's; the sharded trainer's cross-rank exchanges live in
``train/multihost.py``."""

from paddlebox_tpu_torch.distributed.collective import TcpCollective
from paddlebox_tpu_torch.distributed.elastic import (
    ElasticLevel, ElasticManager, FileKVStore, KVStore,
)
from paddlebox_tpu_torch.distributed.kv_server import KVServer, TcpKVStore
from paddlebox_tpu_torch.distributed.launch import (
    LaunchConfig, choose_backend, init_runtime_env, launch_local,
)
from paddlebox_tpu_torch.distributed.shuffle import (
    TcpMesh, TcpShuffler, default_route, deserialize_records,
    serialize_records,
)

__all__ = [
    "ElasticLevel", "ElasticManager", "FileKVStore", "KVStore",
    "KVServer", "TcpKVStore",
    "LaunchConfig", "choose_backend", "init_runtime_env", "launch_local",
    "TcpCollective", "TcpMesh", "TcpShuffler", "default_route",
    "serialize_records", "deserialize_records",
]
