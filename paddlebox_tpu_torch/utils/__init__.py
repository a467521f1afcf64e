from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed
from paddlebox_tpu_torch.utils.dump import DumpConfig, DumpWriter, dump_param
from paddlebox_tpu_torch.utils.fsio import (atomic_write_bytes,
                                            atomic_write_json, read_json)
from paddlebox_tpu_torch.utils.monitor import STATS, StatRegistry, stat_add
from paddlebox_tpu_torch.utils.prefetch import prefetch_iter

__all__ = ["Channel", "ChannelClosed", "DumpConfig", "DumpWriter", "STATS",
           "StatRegistry", "atomic_write_bytes", "atomic_write_json",
           "dump_param", "prefetch_iter", "read_json", "stat_add"]
